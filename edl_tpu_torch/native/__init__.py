"""The port's bindings to the repo's host C++ (``csrc/recordio.cc``,
``csrc/imagedec.cc``): its own ``g++`` build and ``ctypes`` bindings (a
port of the JAX package's ``native/``), with pure-Python fallbacks of the
same on-disk format."""
