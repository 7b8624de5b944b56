"""Builtin checker passes.  Importing this package registers all four
(state-mutation, determinism, dtype, jit-purity) with the registry."""
from . import determinism, dtype, jit_purity, state_mutation
