"""Benchmarks of the port.

* :mod:`.kernel_bench` (``python -m repro_torch.bench.kernel_bench``):
  every kernel against its plain version and the nearest PyTorch call,
  at the reference kernel benchmark's shapes;
* :mod:`.sweep_bench`: the fig6 (alpha x rho) and fig10 sweep grids and
  the parity check of a sweep against a serial loop;
* :mod:`.serve_bench` (``python -m repro_torch.bench.serve_bench``):
  sustained serving throughput, the streamed session against the live
  engine.
"""
