"""The drivers: one a kind of traffic, `<driver>.py` with `run(ctx)`."""
