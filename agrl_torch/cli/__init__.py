"""Command-line entry points (counterpart of agrl_tpu/cli):
`python -m agrl_torch.cli.train_vidreid_xent_htri`."""
