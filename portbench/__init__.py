"""The benchmark of meters_lv2_torch on one NVIDIA card.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Everything
that belongs to one configuration, traffic mix, cell, loop kind, per-layer
metric or kernel count lives in a file of its own, found by name:

  configs/<config>.json     the meters, rate, channels, source, precision
  traffic/<traffic>.json    loop kind, batch, block, pool and signal mix
  workloads/<cell>.json     a configuration and a traffic mix, the sample
                            the check compares and the check's limits
  loops/<kind>.py           how a loop kind drives the port in the window
  metrics/<metric>.py       one per-layer metric's reader
  costs/<kernel>.py         a kernel's fp32 operations and bytes
  reference/                the plain reference the check compares with

Nothing here imports jax or meters_lv2_tpu; nothing under reference/
imports meters_lv2_torch.
"""
