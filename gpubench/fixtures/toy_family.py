"""A toy model family for the harness's own tests (``families/toy.py`` of
a temporary benchmark; no cell of ``BENCHMARK.json`` uses it): least
squares by full-batch gradient descent on ``rows`` x ``dim`` inputs made
from the seed, in float32 on the device, followed for its first
``FOLLOW`` steps by a float64 reference.

Configuration keys: ``family`` ("toy"), ``rows``, ``dim``. Traffic keys:
``family``, ``steps`` (of a job), ``lr``.
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

NAMES = ("loss", "change")
FOLLOW = 3


def check_config(config: dict) -> None:
    for k in ("rows", "dim"):
        if int(config[k]) < 1:
            raise ValueError(f"{k} must be positive, not {config[k]}")


def tiny(cell: dict, **traffic) -> dict:
    cell["traffic"].update(traffic)
    return cell


def faults(cell: dict) -> tuple[str, ...]:
    """``frozen``: a step that leaves the weights as they were."""
    return ("frozen",)


def end_to_end(out: dict) -> dict:
    """``final_loss``: the mean last loss of the finished jobs."""
    last = [t["loss"] for t in out["trainings"] if t["done"]]
    return {"final_loss": sum(last) / len(last) if last else None}


def _inputs(config: dict, seed: int, device: str, dtype=torch.float32):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    x = torch.randn(config["rows"], config["dim"], generator=gen,
                    device=device)
    y = x @ torch.randn(config["dim"], 1, generator=gen, device=device)
    return x.to(dtype), y.to(dtype)


class Run:
    def __init__(self, cell: dict, seed: int, device: str):
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.device = seed, device
        t0 = time.perf_counter()
        self.x, self.y = _inputs(self.config, seed, device)
        self.parts = {"operands_s": time.perf_counter() - t0}

    def warm_up(self) -> None:
        self.job(0, followed_only=True)()

    @contextlib.contextmanager
    def planted(self, fault):
        yield                           # its only fault is the job's own

    def job(self, index, *, deadline=None, follow=False, profiled=False,
            fault=None, followed_only=False) -> "Job":
        steps = FOLLOW if followed_only else self.traffic["steps"]
        return Job(self, deadline, steps, fault)

    def work(self, record: dict) -> dict:
        rows, dim = self.config["rows"], self.config["dim"]
        return {"flops": 4 * rows * dim * record["steps"]}

    def release(self) -> None:
        self.x = self.y = None

    def _follow(self, dtype):
        x, y = (t.cpu().numpy() for t in
                _inputs(self.config, self.seed, self.device, torch.float64))
        x, y = x.astype(dtype), y.astype(dtype)
        w, losses = np.zeros((x.shape[1], 1), dtype), []
        for _ in range(FOLLOW):
            r = x @ w - y
            losses.append(float(np.mean(r * r)))
            w = w - dtype(self.traffic["lr"]) * (2 * x.T @ r / len(x))
        return {"loss": losses, "w_norm": float(np.linalg.norm(w))}

    def check(self, kept: dict, every_leaf: bool = False):
        ref = self._follow(np.float64)
        if len(kept["loss"]) < FOLLOW:
            return dict.fromkeys(NAMES, math.inf), {"ref": ref}
        loss = max(abs(a - b) / abs(b) for a, b in zip(kept["loss"],
                                                       ref["loss"]))
        change = abs(kept["w_norm"] - ref["w_norm"]) / ref["w_norm"]
        return {"loss": loss, "change": change}, {"ref": ref}

    def control(self):
        return "control_fp16", self._follow(np.float16)

    def detail(self, out: dict, notes: dict) -> dict:
        return {"reference_loss": notes["ref"]["loss"]}


class Job:
    def __init__(self, run: Run, deadline, steps: int, fault):
        self.run, self.deadline, self.steps, self.fault = (run, deadline,
                                                          steps, fault)
        self.w = torch.zeros(run.config["dim"], 1, device=run.device)
        self.loss, self.w_norm, self.done = [], None, False

    def __call__(self) -> None:
        x, y, lr = self.run.x, self.run.y, self.run.traffic["lr"]
        for step in range(self.steps):
            # the followed steps run whatever the window's length
            if (self.deadline is not None and step >= FOLLOW
                    and time.perf_counter() >= self.deadline):
                return
            r = x @ self.w - y
            self.loss.append(float(torch.mean(r * r)))
            if self.fault != "frozen":
                self.w = self.w - lr * (2 * x.T @ r / len(x))
            if step + 1 == FOLLOW:
                self.w_norm = float(torch.linalg.vector_norm(self.w))
        self.done = True

    def record(self) -> dict:
        return {"done": self.done, "steps": len(self.loss),
                "nonfinite": sum(not math.isfinite(v) for v in self.loss),
                "loss": self.loss[-1] if self.loss else None}

    def kept(self) -> dict:
        return {"loss": self.loss[:FOLLOW], "w_norm": self.w_norm}
