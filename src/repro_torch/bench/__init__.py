"""Benchmarks and figure drivers of the port (``python -m
repro_torch.bench.<name>``; ``python -m repro_torch.bench.run [suite]``
runs them as the reference's suites).

* :mod:`.table1`, :mod:`.fig5`, :mod:`.fig6`, :mod:`.fig7`, :mod:`.fig8`,
  :mod:`.fig9`, :mod:`.fig10`, :mod:`.fig11`: the paper's table and
  figures, each a port of the reference's driver, through the helpers of
  :mod:`.common` (``run_method_grid``: one sweep a figure);
* :mod:`.kernel_bench`: every kernel against its plain version and the
  nearest PyTorch call, at the reference kernel benchmark's shapes;
* :mod:`.replay_bench`, :mod:`.sweep_bench`: the replay at batch 4,096
  against batch 1, and a sweep against the serial loop (with the fig6 and
  fig10 grids and the parity checks the other drivers share);
* :mod:`.serve_bench`: sustained serving throughput, the streamed session
  against the live engine; :mod:`.integration_bench`: the data pipeline
  and the expert cache; :mod:`.cgm_lanes_bench`: the unlaned device CGM
  against one lane of the laned one.
"""
