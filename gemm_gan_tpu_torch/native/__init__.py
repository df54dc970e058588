"""Native (C++) components of the port: the histogram random forest and the
exact optimal-transport solver.

`hist_forest.cpp` and `ot_emd.cpp` are the port's copies of the JAX
package's sources; `forest` and `ot` bind them with ctypes, and `build`
compiles each with g++ at first use.
"""
