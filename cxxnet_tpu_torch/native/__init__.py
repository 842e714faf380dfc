"""The C ABI of the port (``capi.cc`` over ``wrapper.api``), its C demo and trainer binary; ``build.py`` compiles them."""
