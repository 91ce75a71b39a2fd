"""Batched LM serving driver: prefill once, greedy-decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 4096 --gen 32

The flags are those of ``repro.launch.serve`` plus ``--device`` (``cuda``
by default, which raises without a card; ``cpu`` runs the kernels' plain
versions). Parameters come from a seeded random init, as in the reference.
Prints one JSON line with ``prefill_s``, ``decode_s`` and ``tok_per_s``.
"""
from __future__ import annotations

import argparse
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
                    gen_tokens: int, verbose: bool = False):
    """Prefill the prompt then greedy-decode ``gen_tokens`` tokens.

    Returns the tokens ``(b, gen_tokens)`` as a CPU tensor, the timings
    (host clock around synchronised work) and a record of the run: the
    prefill's and the last step's logits, and each phase's kernel launches
    (``ops.launch_counts``)."""
    with torch.inference_mode():
        return _generate(cfg, params, prompt_batch, max_len, gen_tokens,
                         verbose)


def _generate(cfg, params, prompt_batch, max_len, gen_tokens, verbose):
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
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    after_decode = ops.launch_counts()
    toks = torch.cat(out_tokens, 1).cpu()
    if verbose:
        print("generated token ids:\n", toks.numpy())
    record = {
        "logits": {"prefill": first_logits, "last": logits},
        "launches": {
            "prefill": {k: after_prefill[k] - before[k] for k in before},
            "decode": {k: after_decode[k] - after_prefill[k]
                       for k in before}}}
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tok_per_s": b * (gen_tokens - 1) / max(t_decode, 1e-9)}, \
        record


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
