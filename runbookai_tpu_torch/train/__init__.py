"""Training (the JAX package's ``train/``) on one card: ``trainer.py`` and
``lora_trainer.py``."""
