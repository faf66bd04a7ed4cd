"""Entry points: ``python -m repro_torch.launch.serve unlearn ...`` (the
request server, `serve.unlearn_main`), ``python -m repro_torch.launch.serve
--arch ...`` (batched decode, `serve.decode_main`) and ``python -m
repro_torch.launch.train --arch ...`` (the training driver)."""
