"""batch_wait_ms.train (training data: SceneChunkSampler and device_prefetch;
moves train_step_s): host wall blocked in `next()` on the prefetch iterator,
mean a step of the window."""


def read(run):
    return run.extra.get("batch_wait_ms")
