"""Key and evaluation-context data structures.

Host dataclasses mirroring the reference's wire-format messages
(reference dpf/distributed_point_function.proto:108-171). 128-bit
quantities are Python ints; value corrections are host values typed by the
corresponding hierarchy level's ValueType. Conversion to/from the
byte-compatible protobuf wire format lives in protos/serialization.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from .params import DpfParameters


@dataclasses.dataclass
class CorrectionWord:
    """Per-tree-level correction: seed XOR word, control-bit corrections, and
    (on output levels) the value correction for the *previous* tree layer."""

    seed: int
    control_left: bool
    control_right: bool
    value_correction: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DpfKey:
    """One party's DPF key."""

    seed: int
    correction_words: List[CorrectionWord]
    party: int
    last_level_value_correction: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PartialEvaluation:
    """Saved (prefix -> seed, control bit) state between hierarchy levels."""

    prefix: int
    seed: int
    control_bit: bool


@dataclasses.dataclass
class EvaluationContext:
    """State of a partially evaluated incremental DPF. Serializable and
    resumable between hierarchy levels — this is the framework's
    checkpoint/resume mechanism (SURVEY.md section 5)."""

    parameters: List[DpfParameters]
    key: DpfKey
    previous_hierarchy_level: int = -1
    partial_evaluations: List[PartialEvaluation] = dataclasses.field(default_factory=list)
    partial_evaluations_level: int = 0
