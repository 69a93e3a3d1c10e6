"""Optimizers: AdamW (``optim.adamw``) and int8 error-feedback gradient
compression (``optim.compression``)."""
