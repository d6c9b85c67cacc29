"""What a run hands the per-layer metric readers (`metrics/<name>.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Readings:
    #: the parsed trace of the traced stretch (`metrics._trace.Trace`), or None
    trace: Optional[object] = None
    #: steps inside the traced stretch
    steps_traced: int = 0
    #: steps and seconds of the measured window
    window_steps: int = 0
    window_s: float = 0.0
    #: the configuration's stated precision: "float32" or "bfloat16"
    precision: str = "float32"
    #: one step's convolutions and matmuls (`metrics._flops.step_ops`)
    step_ops: List[Dict] = field(default_factory=list)
    #: bytes of one step's gradients, which a multi-rank step all-reduces
    #: (`metrics._params.grad_bytes`); 0 on one card
    grad_bytes: int = 0
