"""Operational scripts of the port, run as modules
(``python -m semantic_merge_tpu_torch.scripts.<name>``)."""
