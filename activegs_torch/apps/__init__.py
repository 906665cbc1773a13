"""Command-line entry points of the port (`python -m activegs_torch.apps.main`)."""
