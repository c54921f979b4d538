"""`stages.singleton_correction`: the singleton step's wall, mean seconds a
command, from the walls `cli.main` returns."""


def read(cell):
    walls = [w["singleton_correction"] for w in cell.walls if "singleton_correction" in w]
    return sum(walls) / len(walls) if walls else None
