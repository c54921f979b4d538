"""`io.bam` merges and `io.bgzf` deflate: the walls of the rescued merge and the
all-unique merges, mean seconds a command, from the walls `cli.main` returns."""

STEPS = ("merge_rescued", "merge_all_unique")


def read(cell):
    walls = [sum(w[s] for s in STEPS) for w in cell.walls if all(s in w for s in STEPS)]
    return sum(walls) / len(walls) if walls else None
