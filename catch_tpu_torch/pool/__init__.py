# Copied from catch_tpu/pool/__init__.py.
"""Pool optimizer: choose per-dataset parameters under a probe budget."""
