"""The ``command`` driver: the labs' ``consensus`` command, in process.

Set-up generates the cell's BAM from the seed, or reads it back from the
checkout's input cache (``cctbench/_cache/inputs/<config>-<hash>/<seed>``,
written once a seed), and runs the command once on a small input of the
same configuration (a derived seed, a fraction of the fragments), which
loads the port, builds its kernels and the native BGZF library where they
are not built yet, opens the card's context and takes every code path the
window takes.  The traffic's ``ini`` sections go into a ``config.ini``
handed to every command with ``-c`` (the deflate pool's threads).  The
window runs whole commands back to back over the cell's BAM until
``seconds`` have passed; the last one finishes.  Each command writes to the same output directory, which is
moved aside after it.  After the window, the last command's outputs are
held to the reference, and every other command's to the last's, byte for
byte.  The reads are made again from the seed for the check, after the
window.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sys
import time

from cctbench import compare, reference, simulate
from cctbench import trace as trace_mod

NAME = "cell"


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, work: str, device: str,
                 traced: bool):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.work, self.device, self.traced = work, device, traced
        self.out = os.path.join(work, "out")
        self.ini = os.path.join(work, "config.ini")
        self.done: list[str] = []
        self.walls: list[dict] = []
        self.launches: list[int] = []
        self.vote_s: list[float] = []
        self.summary = None
        self.reads = None

    # ------------------------------------------------------------------ argv

    def argv(self, bam: str, out: str) -> list[str]:
        c = self.config["consensus"]
        ini = ["-c", self.ini] if self.traffic.get("ini") else []
        return ["consensus", "-i", bam, "-o", out, "-n", NAME, *ini,
                "--cutoff", str(c["cutoff"]), "--qualscore", str(c["qual_threshold"]),
                "--scorrect", str(bool(c["scorrect"])), "--max_mismatch", str(c["max_mismatch"]),
                "--device", self.device, *self.traffic.get("extra_argv", [])]

    def _run(self, bam: str, out: str) -> dict:
        from consensuscruncher_tpu_torch import cli

        with contextlib.redirect_stdout(sys.stderr):
            return cli.main(self.argv(bam, out))

    # ----------------------------------------------------------------- set-up

    def cached_input(self, sim: dict, seed, name: str) -> str:
        """The BAM of ``sim`` from ``seed`` in the checkout's input cache,
        generated and written there on the seed's first run."""
        from cctbench import run

        key = hashlib.sha256(json.dumps([sim, simulate.STRUCTURE],
                                        sort_keys=True).encode()).hexdigest()[:12]
        seed_key = "-".join(str(s) for s in (seed if isinstance(seed, list) else [seed]))
        folder = os.path.join(run.CACHE_DIR, "inputs", f"{self.config['name']}-{key}", seed_key)
        path = os.path.join(folder, name)
        if not os.path.exists(path):
            os.makedirs(folder, exist_ok=True)
            part = f"{path}.{os.getpid()}.part"
            simulate.make_reads(sim, seed).write(part)
            os.replace(part, path)
        return path

    def setup(self) -> None:
        t = time.perf_counter()
        if self.traffic.get("ini"):
            with open(self.ini, "w") as fh:
                for section, keys in self.traffic["ini"].items():
                    fh.write(f"[{section}]\n")
                    fh.writelines(f"{k} = {v}\n" for k, v in keys.items())
        sim = self.config["simulation"]
        self.input = self.cached_input(sim, self.seed, "input.bam")
        made = time.perf_counter()
        warm_sim = dict(sim, n_fragments=max(1, int(sim["n_fragments"]
                                                    * float(self.traffic["warm_fraction"]))))
        warm_bam = self.cached_input(warm_sim, [self.seed, 1], "warm.bam")
        self._run(warm_bam, os.path.join(self.work, "warm"))
        shutil.rmtree(os.path.join(self.work, "warm"))
        print(f"setup: input {made - t:.3f} s, warm command "
              f"{time.perf_counter() - made:.3f} s", file=sys.stderr)

    # ----------------------------------------------------------------- window

    def window(self, seconds: float) -> dict:
        from consensuscruncher_tpu_torch.ops import consensus_vote

        with contextlib.ExitStack() as stack:
            prof = None
            if self.traced:
                stack.callback(self._instrument())
                prof = stack.enter_context(trace_mod.profiled())
            with trace_mod.span("window", self.traced):
                t0 = self.t0 = time.perf_counter()
                while True:
                    consensus_vote.launches = 0
                    vote_before = self._vote_acc[0] if self.traced else 0.0
                    with trace_mod.span("command", self.traced):
                        res = self._run(self.input, self.out)
                    self.walls.append(dict(res["walls"]))
                    print("command: " + " ".join(f"{k} {v:.3f}" for k, v in res["walls"].items()),
                          file=sys.stderr)
                    self.launches.append(consensus_vote.launches)
                    if self.traced:
                        self.vote_s.append(self._vote_acc[0] - vote_before)
                    done = os.path.join(self.work, f"done{len(self.done)}")
                    os.replace(self.out, done)
                    self.done.append(done)
                    if time.perf_counter() - t0 >= seconds:
                        break
                t1 = time.perf_counter()
        if prof is not None:
            self.summary = trace_mod.from_profiler(prof)
        self.window_s = t1 - t0
        self.reads = simulate.make_reads(self.config["simulation"], self.seed)
        return {"reads_per_s": self.reads.n * len(self.done) / self.window_s}

    def _instrument(self):
        """Wrap the SSCS vote call in synchronised host timers and each
        step in a host span; returns the function that undoes it."""
        import torch

        from consensuscruncher_tpu_torch import cli
        from consensuscruncher_tpu_torch.ops import consensus_segment

        self._vote_acc = [0.0]
        vote = consensus_segment.stream_vote

        def timed_vote(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = vote(*args, **kwargs)
            torch.cuda.synchronize()
            self._vote_acc[0] += time.perf_counter() - t
            return out

        consensus_segment.stream_vote = timed_vote
        saved = {}
        for attr, name in (("run_sscs", "sscs"), ("run_singleton_correction", "singleton"),
                           ("merge_bams", "merge"), ("run_dcs", "dcs"), ("_finish", "finish")):
            fn = saved[attr] = getattr(cli, attr)

            def spanned(*args, _fn=fn, _name=name, **kwargs):
                with trace_mod.span(_name):
                    return _fn(*args, **kwargs)

            setattr(cli, attr, spanned)

        def undo():
            consensus_segment.stream_vote = vote
            for attr, fn in saved.items():
                setattr(cli, attr, fn)

        return undo

    # ------------------------------------------------------------------ check

    def check(self, vote: str = "exact") -> tuple[list, int, int]:
        """``(numbers, attempted, failed)``: each number is ``(name, value,
        limit)``.  ``vote`` other than ``exact`` puts the reference's
        control in the program's place."""
        length = self.reads.codes.shape[1]
        expected = reference.consensus_outputs(self.reads, self.config["consensus"],
                                               device=self.device)
        last = os.path.join(self.done[-1], NAME)
        if vote == "exact":
            observed = compare.observed_outputs(last, NAME, length)
        else:
            observed = reference.consensus_outputs(self.reads, self.config["consensus"], vote,
                                                   device=self.device)
        nums = compare.compare_consensus(expected, observed)
        digest = compare.output_digest(last, NAME)
        differing = sum(compare.output_digest(os.path.join(d, NAME), NAME) != digest
                        for d in self.done[:-1])
        wrong_last = nums["records_wrong"] + nums["stats_wrong"] + nums["records_unsorted"] > 0
        numbers = [("records_wrong", nums["records_wrong"], 0),
                   ("stats_wrong", nums["stats_wrong"], 0),
                   ("records_unsorted", nums["records_unsorted"], 0),
                   ("commands_differing", differing, 0)]
        failed = len(self.done) if wrong_last else differing
        return numbers, len(self.done), failed
