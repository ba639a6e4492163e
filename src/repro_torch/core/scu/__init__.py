"""Own copies of the parts of ``repro.core.scu`` that the port needs: the op
records (``engine``) and the synchronisation fragments (``primitives``).

The simulator itself (the engine, the SCU model, the fleets) is numpy and is
not ported; only its array executor ran on the accelerator, and that is owed
as the trace executor.
"""
