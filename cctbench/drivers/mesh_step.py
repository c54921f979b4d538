"""The ``mesh_step`` driver: the library's whole-pipeline duplex step.

``parallel.mesh.full_pipeline_step`` on a mesh of the card the run is
given (one shard), with the configuration's consensus settings, on
raw-wire batches that already sit on the card.  Set-up makes a pool of
``pairs + pool_steps - 1`` duplex pairs from the seed on the card (a
``torch.Generator`` there, in blocks of pairs): ``family_slots`` member
slots a strand, every strand family's size drawn from the configuration's
law, strand B empty for the pairs that are not duplex.  The families'
sizes are host arrays, as a caller that planned the batch holds them.
Step ``i`` takes the ``pairs`` pairs from offset ``i mod pool_steps``, so
no two of the window's first ``pool_steps`` steps are handed the same
batch: a step that served a result it held for an input it saw before
would hand back the wrong one.  Set-up runs the step once at the window's
shape.  The window enqueues steps back to back and synchronises once, at
its end.

Every step's stats vector is held to the reference (the pool's per-pair
stats, summed over the step's pairs); of the planes, a sample of steps
drawn from the seed (a reservoir of ``sample`` steps over the whole
window) and the last step.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from cctbench import reference, work
from cctbench import trace as trace_mod

BLOCK = 2048  # pairs generated, and voted by the reference, at a time


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, work_dir: str, device: str,
                 traced: bool):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.traced = device, traced
        self.pairs = int(traffic["pairs"])
        self.pool_steps = int(traffic["pool_steps"])
        self.summary = None
        self.steps = 0
        self.host_s = 0.0

    def make_pool(self, gen, pairs: int, slots: int) -> tuple:
        """``(bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b)``: the
        planes ``(pairs, slots, L)`` uint8 on the card, the sizes on the
        host."""
        import torch

        sim = self.config["simulation"]
        length, law = int(sim["read_len"]), sim["family_size"]
        dev = self.device
        rate = torch.full((pairs,), float(law["poisson_mean"]), device=dev)
        sizes = [(torch.poisson(rate, generator=gen).to(torch.int64)
                  + int(law["offset"])).clamp(min=int(law["min"])) for _strand in range(2)]
        duplex = torch.rand(pairs, generator=gen, device=dev) < float(sim["duplex_fraction"])
        sizes[1] = torch.where(duplex, sizes[1], 0)
        planes = [torch.empty((pairs, slots, length), dtype=torch.uint8, device=dev)
                  for _ in range(4)]
        for lo in range(0, pairs, BLOCK):
            n = min(BLOCK, pairs - lo)
            template = torch.randint(0, 4, (n, 1, length), generator=gen, device=dev,
                                     dtype=torch.uint8)
            for strand in range(2):
                err = torch.rand((n, slots, length), generator=gen, device=dev) \
                    < float(sim["error_rate"])
                noise = torch.randint(0, 4, (n, slots, length), generator=gen, device=dev,
                                      dtype=torch.uint8)
                planes[2 * strand][lo:lo + n] = torch.where(err, noise, template)
                planes[2 * strand + 1][lo:lo + n] = torch.randint(
                    int(sim["qual_lo"]), int(sim["qual_hi"]) + 1, (n, slots, length),
                    generator=gen, device=dev, dtype=torch.uint8)
        sa, sb = (s.cpu().numpy() for s in sizes)
        if max(sa.max(), sb.max()) > slots:
            raise ValueError(f"a family of {max(sa.max(), sb.max())} members overflows "
                             f"{slots} slots")
        return planes[0], planes[1], sa, planes[2], planes[3], sb

    def batch(self, i: int) -> tuple:
        o = i % self.pool_steps
        rows = slice(o, o + self.pairs)
        return tuple(x[rows] for x in self.pool)

    def setup(self) -> None:
        import torch

        from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
        from consensuscruncher_tpu_torch.parallel import mesh

        t = self.traffic
        start = time.perf_counter()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.pool = self.make_pool(gen, self.pairs + self.pool_steps - 1,
                                   int(t["family_slots"]))
        cons = self.config["consensus"]
        config = ConsensusConfig(cutoff=float(cons["cutoff"]),
                                 qual_threshold=int(cons["qual_threshold"]),
                                 qual_cap=int(cons["qual_cap"]))
        card = torch.device("cuda", 0) if self.device == "cuda" else torch.device(self.device)
        self.step = mesh.full_pipeline_step(mesh.make_mesh(devices=[card]), config)
        self.step(*self.batch(0))
        if self.device != "cpu":
            torch.cuda.synchronize()
        print(f"setup: pool of {self.pairs + self.pool_steps - 1} pairs made and a step "
              f"run in {time.perf_counter() - start:.3f} s", file=sys.stderr)

    def window(self, seconds: float) -> dict:
        import torch

        sample = int(self.traffic["sample"])
        rng = np.random.default_rng([self.seed, 2])
        kept: list[tuple[int, tuple]] = []
        self.stats: list = []
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(trace_mod.profiled()) if self.traced else None
            with trace_mod.span("window", self.traced):
                t0 = self.t0 = time.perf_counter()
                i = 0
                while True:
                    h = time.perf_counter()
                    with trace_mod.span("step", self.traced):
                        out = self.step(*self.batch(i))
                    self.host_s += time.perf_counter() - h
                    self.stats.append(out[-1])
                    if i < sample:
                        kept.append((i, out[:-1]))
                    else:
                        j = int(rng.integers(0, i + 1))
                        if j < sample:
                            kept[j] = (i, out[:-1])
                    last = (i, out[:-1])
                    i += 1
                    if time.perf_counter() - t0 >= seconds:
                        break
                if self.device != "cpu":
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
        if prof is not None:
            self.summary = trace_mod.from_profiler(prof)
        if all(k[0] != last[0] for k in kept):
            kept.append(last)
        self.kept = kept
        self.steps = i
        self.window_s = t1 - t0
        return {"pairs_per_s": self.pairs * i / self.window_s}

    def step_work(self) -> list[dict]:
        """The work (``work.duplex_step``) of each of the window's steps."""
        sa, sb = self.pool[2], self.pool[5]
        length = int(self.config["simulation"]["read_len"])
        live = np.concatenate([[0], np.cumsum(sa.astype(np.int64) + sb)])
        offsets = np.arange(self.steps) % self.pool_steps
        return [work.duplex_work(int(n), self.pairs, length)
                for n in live[offsets + self.pairs] - live[offsets]]

    def check(self, vote: str = "exact") -> tuple[list, int, int]:
        """``(numbers, attempted, failed)``: planes' positions and stats
        vectors that differ from the reference's.  ``vote`` other than
        ``exact`` puts the reference's control in the program's place."""
        import torch

        cons = self.config["consensus"]
        ba, qa, sa, bb, qb, sb = self.pool
        total = ba.shape[0]
        # the reference pair by pair over the pool; a step's stats are the
        # sums of its pairs' (prefix sums), its planes a slice
        want, got = [], []
        for lo in range(0, total, BLOCK):
            hi = min(total, lo + BLOCK)
            args = (ba[lo:hi], qa[lo:hi], sa[lo:hi], bb[lo:hi], qb[lo:hi], sb[lo:hi], cons)
            want.append(reference.duplex_step(*args, per_pair=True))
            if vote != "exact":
                got.append(reference.duplex_step(*args, vote=vote, per_pair=True))
        want_planes = torch.cat([w[0] for w in want], 1)
        want_sums = _prefix(torch.cat([w[1] for w in want]))
        offsets = torch.arange(self.steps) % self.pool_steps
        want_stats = want_sums[offsets + self.pairs] - want_sums[offsets]
        if vote == "exact":
            got_planes = {i: torch.stack(list(p)) for i, p in self.kept}
            got_stats = torch.stack([s.to(torch.int64) for s in self.stats]).cpu()
        else:
            planes = torch.cat([g[0] for g in got], 1)
            sums = _prefix(torch.cat([g[1] for g in got]))
            got_planes = {i: planes[:, i % self.pool_steps:i % self.pool_steps + self.pairs]
                          for i, _p in self.kept}
            got_stats = sums[offsets + self.pairs] - sums[offsets]
        wrong_steps = set()
        positions = 0
        for i, planes in got_planes.items():
            o = i % self.pool_steps
            bad = int((planes != want_planes[:, o:o + self.pairs]).sum())
            positions += bad
            if bad:
                wrong_steps.add(i)
        stat_bad = (got_stats != want_stats).any(1)
        wrong_steps |= set(np.nonzero(stat_bad.numpy())[0].tolist())
        numbers = [("plane_positions_wrong", positions, 0),
                   ("stats_wrong", int(stat_bad.sum()), 0)]
        return numbers, self.steps, len(wrong_steps)


def _prefix(per_pair):
    """``(P, 4)`` per-pair stats -> ``(P + 1, 4)`` int64 prefix sums on the host."""
    import torch

    per_pair = per_pair.to(torch.int64).cpu()
    return torch.cat([torch.zeros((1, per_pair.shape[1]), dtype=torch.int64),
                      per_pair.cumsum(0)])
