"""Offline evaluation tools: the evaluation index and metric recomputation."""
