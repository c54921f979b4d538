"""`ops.consensus_segment` / `ops.consensus_vote`: the SSCS vote calls, seconds a
command, on a host clock with the card synchronised before and after each
`consensus_segment.stream_vote` call (the benchmark wraps it in the traced
run only)."""


def read(cell):
    return sum(cell.vote_s) / len(cell.vote_s) if cell.vote_s else None
