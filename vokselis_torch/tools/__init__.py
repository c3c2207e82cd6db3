"""Command-line tools of the port (run as ``python -m vokselis_torch.tools.<name>``)."""
