"""Multi-device paths of the port (torch.distributed)."""
