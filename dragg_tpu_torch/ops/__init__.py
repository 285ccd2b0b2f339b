"""Solver operators: QP assembly, band factor/solves and the interior point."""
