"""Host-side helpers: NumPy <-> tensor carry-across, synthetic pairs,
trace scopes."""
