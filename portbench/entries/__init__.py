"""The program's entry points the cells time, one module each, found by
the name a traffic file gives (`entry`). A module's `make(cfg, device,
traffic)` returns a callable taking a call's pairs, as (raw scene,
padded x1, x2, valid) tuples, and the call's seed, and returning each
pair's (labels, models, active) as host arrays; it has `captured`
(whether the timed path replays a CUDA graph)."""
