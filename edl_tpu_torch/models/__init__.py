"""Models: the decoder-only transformer LM, ResNet, linear regression,
Wide&Deep, the MNIST CNN, the text classifiers, VGG, and the weight
converter."""
