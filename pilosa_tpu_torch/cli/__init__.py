"""The port's command line: `python -m pilosa_tpu_torch.cli server
--config <toml>` starts a node (cli/main.py; pilosa_tpu/cli/)."""
