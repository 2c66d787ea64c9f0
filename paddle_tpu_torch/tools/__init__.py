"""Operator tools of the port, run as modules
(`python -m paddle_tpu_torch.tools.ptpu_elastic`)."""
