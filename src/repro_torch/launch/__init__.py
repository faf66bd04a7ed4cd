"""Entry points: ``python -m repro_torch.launch.serve unlearn ...`` (the
request server, `serve.unlearn_main`)."""
