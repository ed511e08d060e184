"""Low-level compute: circuit IR, batched statevector engine, GP linalg."""

from .circuit import Circuit, Gate, ENC_ID, ENC_ARCCOS, ENC_NONE
from .statevector import (
    angle_matrix,
    batched_states,
    pauli_features,
    state_from_angles,
)
