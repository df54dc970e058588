"""Native (C++) components of the port: the histogram random forest.

`hist_forest.cpp` is the port's copy of the JAX package's source; `forest`
builds it with g++ at first use and binds it with ctypes.
"""
