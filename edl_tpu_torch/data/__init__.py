"""Input pipelines: the image records and batches of ``data/images.py``."""
