"""Own copies of the parts of ``repro.core.scu`` that the port needs: the op
records (``engine``), the synchronisation fragments (``primitives``), the
trace IR (``trace``) and the lowering of the microbenchmarks to it
(``programs``), and the part of the simulator that ran on the accelerator,
the batched trace executor (``trace_exec``).

The engine itself, the SCU model and the fleets are numpy and are not
ported; the engine is the oracle the trace executor is held to.
"""

from .programs import trace_barrier_programs, trace_chain_programs, trace_mutex_programs
from .trace import (
    T_BR,
    T_COMPUTE,
    T_HALT,
    T_JMP,
    T_LOOP,
    T_MEM,
    T_POLL,
    T_SCU,
    TraceBuilder,
    TraceProgram,
    Untraceable,
    lower_or_fallback,
    trace_fragments,
    trace_generator,
)
from .trace_exec import BLOCK_CYCLES, control_depth, run_traces_torch

__all__ = [
    "T_COMPUTE",
    "T_MEM",
    "T_POLL",
    "T_SCU",
    "T_JMP",
    "T_BR",
    "T_LOOP",
    "T_HALT",
    "Untraceable",
    "TraceBuilder",
    "TraceProgram",
    "trace_generator",
    "trace_fragments",
    "lower_or_fallback",
    "trace_barrier_programs",
    "trace_chain_programs",
    "trace_mutex_programs",
    "run_traces_torch",
    "control_depth",
    "BLOCK_CYCLES",
]
