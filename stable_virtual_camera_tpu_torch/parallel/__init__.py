"""Multi-device sampling: the ("data", "view") mesh, its collectives, ring
attention and the sharded samplers (counterpart of
stable_virtual_camera_tpu/parallel/)."""
