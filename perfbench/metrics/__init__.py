"""Per-layer metrics: one reader per metric, `<metric name>.py`, whose
`read(ctx)` returns the metric's value, or None where it finds nothing to
read (the metric is then left out of the result's line). A training cell
(`cells/train_epochs.py`) builds `ctx` after a `--trace 1` run's traced
window:

* `trace`: the traced epoch's reduction (`trace.Reduced`): its device
  records, every device and host record after the sentinels, busy and
  window seconds, sums by name;
* `trace_steps`: the training steps of the traced epoch;
* `window_steps`, `window_s`: the run's untraced window, its steps and its
  seconds on the host's clock;
* `step_flops`: one step's FLOPs (`train_step_flops` of
  `flops/<architecture>.py`);
* `peak_flops`: the configuration's peak (its `peak` key in `peaks.json`);
* `peaks`: the card's row of `peaks.json`;
* `sites`: the attentions routed to the flash kernels (`kernel_sites` of
  the same module), each with its `launches` a step;
* `kernels`: {kernel name: bound module} of `kernels/`.
"""
