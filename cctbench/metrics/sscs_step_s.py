"""`stages.sscs_maker`: the SSCS step's wall (decode, grouping, batching, the vote
call, the SSCS writes), mean seconds a command, from the walls `cli.main` returns."""


def read(cell):
    walls = [w["sscs"] for w in cell.walls if "sscs" in w]
    return sum(walls) / len(walls) if walls else None
