"""Command-line entry points of the port (`python -m kgtpu_torch.cli.<name>`):
`test` (inference over a dataset), `eval` (mask AP of its outputs) and
`bench` (the headline e2e img/s)."""
