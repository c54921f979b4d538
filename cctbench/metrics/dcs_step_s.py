"""`stages.dcs_maker` with `ops.residency` and `ops.duplex`: the DCS step's wall,
mean seconds a command, from the walls `cli.main` returns."""


def read(cell):
    walls = [w["dcs"] for w in cell.walls if "dcs" in w]
    return sum(walls) / len(walls) if walls else None
