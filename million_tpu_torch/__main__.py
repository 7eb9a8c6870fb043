"""`python -m million_tpu_torch` runs the pipeline CLI (million_tpu_torch.cli)."""

from million_tpu_torch.cli import main

main()
