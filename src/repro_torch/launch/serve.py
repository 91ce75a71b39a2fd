"""Batched LM serving driver: prefill once, greedy-decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 4096 --gen 32

The flags are those of ``repro.launch.serve`` plus ``--device`` (``cuda``
by default, which raises without a card; ``cpu`` runs the kernels' plain
versions). Parameters come from a seeded random init, as in the reference.
Prints one JSON line with ``prefill_s``, ``decode_s`` and ``tok_per_s``.

``sharded_generate`` serves on a (data × model) mesh of ranks (the
library's entry; the reference's CLI has no mesh either), through the
sharded prefill and decode steps and ``sharded_graft``.
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from repro_torch.configs import get_arch, make_batch, smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.lm.backbone import init_cache, init_params
from repro_torch.train.lm_steps import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def graft(cfg, prefill_cache: dict, batch: int, max_len: int,
          device) -> dict:
    """The prefill cache grown into a ``max_len`` decode cache: each full
    attention layer's k/v (or MLA's ``ckv`` / ``krope`` latents) copied
    into the first positions; ring buffers, cross-attention k/v and the
    recurrent states (RG-LRU, mLSTM, sLSTM), whose shapes do not grow,
    taken as they are."""
    full = init_cache(cfg, batch, max_len, device)
    for dst, src in zip(full["layers"], prefill_cache["layers"]):
        for name, t in src.items():
            if dst[name].shape == t.shape:
                dst[name] = t
            else:
                dst[name][:, : t.shape[1]] = t
    full["len"] = prefill_cache["len"]
    return full


def greedy_generate(cfg, params, prompt_batch: dict, max_len: int,
                    gen_tokens: int, verbose: bool = False,
                    keep_logits: bool = False):
    """Prefill the prompt then greedy-decode ``gen_tokens`` tokens.

    Returns the tokens ``(b, gen_tokens)`` as a CPU tensor, the timings
    (host clock around synchronised work) and a record of the run: the
    prefill's and the last step's logits (every decode step's under
    ``"steps"`` with ``keep_logits``), and each phase's kernel launches
    (``ops.launch_counts``)."""
    with torch.inference_mode():
        return _generate(cfg, params, prompt_batch, max_len, gen_tokens,
                         verbose, keep_logits)


def _generate(cfg, params, prompt_batch, max_len, gen_tokens, verbose,
              keep_logits):
    b = next(iter(prompt_batch.values())).shape[0]
    device = next(iter(prompt_batch.values())).device
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    before = ops.launch_counts()
    t0 = time.perf_counter()
    first_logits, cache = prefill(params, prompt_batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    after_prefill = ops.launch_counts()

    cache = graft(cfg, cache, b, max_len, device)
    logits = first_logits
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out_tokens, steps = [tok], []
    t0 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out_tokens.append(tok)
        if keep_logits:
            steps.append(logits)
    _sync(device)
    t_decode = time.perf_counter() - t0
    after_decode = ops.launch_counts()
    toks = torch.cat(out_tokens, 1).cpu()
    if verbose:
        print("generated token ids:\n", toks.numpy())
    record = {
        "logits": {"prefill": first_logits, "last": logits,
                   **({"steps": steps} if keep_logits else {})},
        "launches": {
            "prefill": {k: after_prefill[k] - before[k] for k in before},
            "decode": {k: after_decode[k] - after_prefill[k]
                       for k in before}}}
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tok_per_s": b * (gen_tokens - 1) / max(t_decode, 1e-9)}, \
        record


# ------------------------------------------------------------ on a mesh
def _regrid(x: torch.Tensor, src, dst, whole: tuple) -> torch.Tensor:
    """This rank's block under ``dst`` (a ``Sharding``) of a leaf whose
    block under ``src`` is ``x``, the whole leaf being ``whole`` under
    ``dst`` and padded with zeros past ``x``'s extent: every dimension
    split over ``model`` in ``src`` is all-gathered over ``model``, then
    cut to ``dst``'s block. The batch axes hold the same rows in both."""
    mesh = src.mesh
    for d, a in enumerate(src.axes(x.ndim)):
        if a == "model":
            x = mesh.all_gather(x, "model", d)
    for d, a in enumerate(dst.axes(x.ndim)):
        if a not in (None, "model"):
            continue
        k = mesh.axis_size(a)
        lo = mesh.index(a) * whole[d] // k if k > 1 else 0
        n = whole[d] // k
        have = max(0, min(x.shape[d] - lo, n))
        x = x.narrow(d, min(lo, x.shape[d]), have)
        if have < n:
            pad = list(x.shape)
            pad[d] = n - have
            x = torch.cat([x, x.new_zeros(pad)], d)
    return x.contiguous()


def sharded_graft(cfg, prefill_cache: dict, max_len: int, mesh) -> dict:
    """``graft`` on a mesh: this rank's blocks of a sharded prefill's
    cache (``train.lm_steps.make_sharded_prefill_step``) grown into its
    blocks of the ``max_len`` decode cache. The sequence-split caches
    change their split (the prompt's ``t / model`` positions a rank to
    ``max_len / model``), so each is redistributed across the ``model``
    ranks (all-gathered over ``model`` and cut, one layer at a time);
    ring buffers, cross-attention k/v and the recurrent states keep their
    shapes and blocks. Every rank of the mesh must call it."""
    from repro_torch.convert import lm_cache_shardings
    from repro_torch.train.lm_steps import abstract_cache
    layers = prefill_cache["layers"]
    rows = next(iter(layers[0].values())).shape[0] \
        * mesh.axis_size(mesh.dp_axes)
    ring = next((int(c["pos"].shape[0]) for c in layers if "pos" in c),
                None)
    src_abs = abstract_cache(cfg, rows, prefill_cache["max_len"], ring)
    dst_abs = abstract_cache(cfg, rows, max_len)
    src_sh = lm_cache_shardings(cfg, mesh, src_abs)["layers"]
    dst_sh = lm_cache_shardings(cfg, mesh, dst_abs)["layers"]
    out = []
    for c, s_sh, d_sh, s_abs, d_abs in zip(layers, src_sh, dst_sh,
                                           src_abs["layers"],
                                           dst_abs["layers"]):
        new = {}
        for name, x in c.items():
            whole = tuple(d_abs[name].shape)
            if whole == tuple(s_abs[name].shape) and \
                    s_sh[name].spec == d_sh[name].spec:
                new[name] = x
            else:
                new[name] = _regrid(x, s_sh[name], d_sh[name], whole)
        out.append(new)
    return {"layers": out, "len": prefill_cache["len"], "max_len": max_len}


def sharded_generate(cfg, state, prompt_batch: dict, max_len: int,
                     gen_tokens: int, mesh, feed: torch.Tensor | None = None,
                     keep_logits: bool = False):
    """``greedy_generate`` on a mesh: this rank's rows of the prompt
    (``train.lm_steps.local_batch``) prefilled by
    ``make_sharded_prefill_step``, the cache grafted (``sharded_graft``),
    then ``gen_tokens - 1`` decode steps, each token the argmax of the
    logits gathered whole over ``model``. With ``feed`` ((rows,
    gen_tokens) ints) step ``i`` is fed ``feed[:, i]`` instead (teacher
    forcing; the argmax is still what comes back). Every rank of the mesh
    must call it.

    Returns the greedy tokens ``(rows, gen_tokens)`` (CPU), the timings
    (host clock around synchronised work: ``prefill_s``, ``graft_s``,
    ``decode_s``, ``tok_per_s`` of this rank's rows) and a record: the
    prefill's and the last step's logits (every step's with
    ``keep_logits``), each phase's kernel launches and the mesh's
    collectives (``Mesh.stats``) of the prefill and of all decode steps."""
    from repro_torch.train.lm_steps import make_sharded_decode_step, \
        make_sharded_prefill_step
    rows = next(iter(prompt_batch.values())).shape[0]
    device = next(iter(prompt_batch.values())).device
    prefill = make_sharded_prefill_step(cfg, mesh)
    decode = make_sharded_decode_step(cfg, mesh)
    record = {"launches": {}, "collectives": {}, "logits": {}}

    def phase(name, fn):
        mesh.reset_stats()
        before = ops.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        sec = time.perf_counter() - t0
        after = ops.launch_counts()
        record["launches"][name] = {k: after[k] - before[k] for k in after}
        record["collectives"][name] = copy.deepcopy(mesh.stats)
        return out, sec

    (logits, cache), t_prefill = phase(
        "prefill", lambda: prefill(state, prompt_batch))
    record["logits"]["prefill"] = logits
    cache, t_graft = phase(
        "graft", lambda: sharded_graft(cfg, cache, max_len, mesh))
    toks = [logits[:, -1].argmax(-1).to(torch.int32)[:, None]]
    steps = []

    def run_decode():
        nonlocal logits, cache
        for i in range(gen_tokens - 1):
            tok = toks[-1] if feed is None else \
                feed[:, i:i + 1].to(device, torch.int32)
            logits, cache = decode(state, cache, {"tokens": tok})
            toks.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
            if keep_logits:
                steps.append(logits)

    _, t_decode = phase("decode", run_decode)
    record["logits"]["last"] = logits
    if keep_logits:
        record["logits"]["steps"] = steps
    record["cache"] = cache
    return torch.cat(toks, 1).cpu(), {
        "prefill_s": t_prefill, "graft_s": t_graft, "decode_s": t_decode,
        "tok_per_s": rows * (gen_tokens - 1) / max(t_decode, 1e-9)}, record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="LM serving: prefill + greedy decode (PyTorch port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def run(args) -> dict:
    """Serve one batch; returns the JSON report (under ``report``) and the
    objects a caller may check: config, params, prompt, tokens, record."""
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    params = init_params(cfg, args.seed, device)
    prompt = make_batch(cfg, "prefill_32k", args.batch, args.prompt_len,
                        seed=args.seed, device=device)
    max_len = args.prompt_len + args.gen + 1
    toks, stats, record = greedy_generate(cfg, params, prompt, max_len,
                                          args.gen, verbose=args.verbose)
    if tuple(toks.shape) != (args.batch, args.gen):
        raise RuntimeError(f"generated {tuple(toks.shape)} tokens, expected "
                           f"{(args.batch, args.gen)}")
    report = {"arch": cfg.name, "batch": args.batch, "gen": args.gen,
              **{k: round(v, 4) for k, v in stats.items()}}
    return {"report": report, "cfg": cfg, "params": params,
            "prompt": prompt, "tokens": toks, "stats": stats, **record}


def main(argv=None) -> dict:
    out = run(build_parser().parse_args(argv))
    print(json.dumps(out["report"]))
    return out


if __name__ == "__main__":
    main()
