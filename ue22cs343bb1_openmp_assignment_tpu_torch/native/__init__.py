"""native: the host-side C++ oracle (``engine.cpp``, ``bindings.py``)."""
