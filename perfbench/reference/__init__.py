"""The plain fp32 reference that decides a run's `correct`.

Written from the published architecture (Stability-AI/stable-virtual-camera
`seva/modules`, the SD2.1 AutoencoderKL, OpenCLIP ViT-H/14) in plain
`torch` operations, with the parameter names of the port's state dict so
that both read the weights the benchmark makes. It imports nothing of the
port and nothing of the JAX package, and runs no kernel of the port.
"""
