"""`ops.consensus_vote`: B1 launches a command (`consensus_vote.launches`)."""


def read(cell):
    return sum(cell.launches) / len(cell.launches) if cell.launches else None
