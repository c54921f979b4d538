"""The device: the share of the window in which no kernel, copy or set ran on
the card (`torch.profiler`, CUDA activity).  Reads `device_idle_pct.<split>`
for every split, each moving its own cells' end-to-end metric."""


def read(cell):
    s = cell.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
