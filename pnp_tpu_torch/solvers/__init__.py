"""Krylov, Newton, preconditioners and dense direct solves."""
