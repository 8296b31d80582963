"""Single-card fine-tuning: the teacher-forced train step, the optimizer
pieces of ``optax`` the JAX package uses, and the manifest data pipeline."""
