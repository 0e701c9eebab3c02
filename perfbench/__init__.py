"""The benchmark of the PyTorch/CUDA port (`stable_virtual_camera_tpu_torch`).

One command runs one cell once (see run.py). Everything that belongs to one
configuration, traffic mix, cell or per-layer metric is a file of its own,
found by the name BENCHMARK.json gives it: configs/<config>.json,
traffic/<traffic>.json (which names its driver, drivers/<driver>.py),
limits/<cell>.json and layer_metrics/<metric>.py. The plain reference that
decides `correct` is reference/, the FLOP and byte arithmetic counts/.
"""
