"""Drivers that run the port for a result: ``convergence`` (train a model
on the procedural data to a held-out accuracy, with a resume halfway and an
int8 evaluation) and ``soak`` with ``soak_audit`` (the CLI killed by SIGKILL
between checkpoints, resumed, and audited). Each runs as ``python -m
resnet_tpu_torch.tools.<name>``; they are the counterparts of the JAX
package's ``tools/convergence_run.py``, ``tools/soak.py`` and
``tools/soak_audit.py``."""
