"""Own copies of the parts of ``repro.core`` that the port needs."""
