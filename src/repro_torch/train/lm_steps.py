"""LM steps: train (microbatched gradient accumulation), prefill, decode.

The port of ``repro.train.lm_steps``. The reference's steps are
``jax.jit``-able pure functions; these run eagerly. The train step updates
the module's parameters (and the optimizer's moments) in place and returns
them; prefill and decode run under ``torch.inference_mode``.

``make_sharded_train_step`` is the train step on a (data × model) mesh,
one process per rank (the reference jits its one step with the mesh's
shardings): FSDP over the batch axes and tensor parallelism over
``model`` for every family (heads, ffn columns, experts, the LRU width;
``models.lm.sharding``), the reference's global RSC block selection, and
a vocab-parallel cross-entropy. ``make_sharded_prefill_step`` and
``make_sharded_decode_step`` serve on the same mesh and parameter layout
under ``DECODE_RULES``, the KV cache sequence parallel over ``model``.
``abstract_state`` and ``abstract_cache`` size a cell on the ``meta``
device, allocating nothing.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm.backbone import LM, ShardedLM, forward, \
    forward_sharded, layer_cache
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.sharding import DECODE_RULES, TRAIN_RULES, \
    check_tensor_parallel, mesh_context
from repro_torch.train.optimizer import Adam, apply_updates


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL, ``mean(logsumexp − picked)``; logits f32 (b, t, v).
    Picking the target's logit with ``gather`` gives exactly the
    reference's one-hot sum (one nonzero term) without its (b, t, v)
    one-hot tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - picked).mean()


def _grads(loss: torch.Tensor, named: dict) -> list[torch.Tensor]:
    """d loss / d each parameter; zeros for one the loss does not use
    (an embedding-input model's ``embed`` in training), as
    ``jax.value_and_grad`` gives."""
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(named.values(), gs)]


def _fwd_kwargs(batch: dict) -> dict:
    return {k: batch[k] for k in ("tokens", "embeds", "cross_states")
            if k in batch}


def make_train_step(cfg: LMConfig, opt: Adam, n_microbatches: int = 1,
                    rsc: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``. Microbatch ``i`` takes batch rows ``[i·b/n, (i+1)·b/n)``; their
    gradients are added into f32 accumulators and divided by ``n``, and
    the loss is the mean of theirs. With ``n = 1`` the raw gradients (in
    the parameters' dtype) go to the optimizer, as in the reference."""
    def loss_fn(params: LM, mb: dict) -> torch.Tensor:
        logits, _ = forward(params, cfg, mode="train", rsc=rsc,
                            **_fwd_kwargs(mb))
        return cross_entropy(logits, mb["targets"])

    def train_step(params: LM, opt_state: dict, batch: dict):
        named = dict(params.named_parameters())
        if n_microbatches == 1:
            loss = loss_fn(params, batch)
            grads = dict(zip(named, _grads(loss, named)))
            loss = loss.detach()
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_microbatches:
                raise ValueError(f"batch {rows} is not a multiple of "
                                 f"{n_microbatches} microbatches")
            per = rows // n_microbatches
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in named.items()}
            lsum = 0.0
            for i in range(n_microbatches):
                mb = {k: x[i * per:(i + 1) * per] for k, x in batch.items()}
                l = loss_fn(params, mb)
                gs = _grads(l, named)
                for k, g in zip(named, gs):
                    gsum[k] += g.float()
                lsum = lsum + l.detach()
                del l, gs
            grads = {k: g.div_(n_microbatches) for k, g in gsum.items()}
            loss = lsum / n_microbatches
        updates, opt_state = opt.update(grads, opt_state, named)
        del grads
        apply_updates(named, updates)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: LMConfig):
    def prefill_step(params: LM, batch: dict):
        with torch.inference_mode():
            return forward(params, cfg, mode="prefill", last_only=True,
                           **_fwd_kwargs(batch))

    return prefill_step


def make_decode_step(cfg: LMConfig):
    def decode_step(params: LM, cache: dict, batch: dict):
        with torch.inference_mode():
            return forward(params, cfg, mode="decode", cache=cache,
                           **_fwd_kwargs(batch))

    return decode_step


# ------------------------------------------------------------ on a mesh
class _VocabParallelNLL(torch.autograd.Function):
    """``Σ (logsumexp − picked) / n_total`` over this rank's tokens, with
    the logits' vocab split over ``model``: the max and the sum of
    exponentials are reduced over ``model``, and the picked logit comes
    from the rank that holds the target's row."""

    @staticmethod
    def forward(ctx, logits, targets, n_total, mesh):
        v = logits.shape[-1]
        ids = targets.long() - mesh.index("model") * v
        ok = (ids >= 0) & (ids < v)
        ids = ids.clamp(0, v - 1)
        mx = mesh.all_reduce(logits.amax(-1), "model", "max")
        e = torch.exp(logits - mx[..., None])
        se = mesh.all_reduce(e.sum(-1), "model")
        picked = logits.gather(-1, ids[..., None])[..., 0] * ok
        picked = mesh.all_reduce(picked, "model")
        nll = torch.log(se) + mx - picked
        e /= se[..., None]                       # the softmax, in place
        ctx.save_for_backward(e, ids, ok)
        ctx.n_total = n_total
        return nll.sum() / n_total

    @staticmethod
    def backward(ctx, gl):
        p, ids, ok = ctx.saved_tensors
        grad = p.scatter_add(-1, ids[..., None], -ok[..., None].to(p.dtype))
        return grad * (gl / ctx.n_total), None, None, None


def sharded_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          n_total: int, mesh) -> torch.Tensor:
    """This rank's share of the mean token NLL over ``n_total`` tokens
    (``logits`` f32, vocab split over ``model``); the shares of the ranks
    along the batch axes sum to the mean, and the ``model`` ranks hold
    equal ones."""
    return _VocabParallelNLL.apply(logits, targets, n_total, mesh)


def local_batch(batch: dict, mesh, n_microbatches: int = 1) -> dict:
    """This rank's rows of a global ``batch`` in its microbatch order:
    from each global microbatch (rows ``[i·b/n, (i+1)·b/n)``, as the
    reference takes them) the block of its index over the batch axes.
    (A contiguous block of the whole batch would give each rank other
    microbatches than the reference's, and RSC picks its blocks per
    microbatch.)"""
    dp = mesh.axis_size(mesh.dp_axes)
    rows = next(iter(batch.values())).shape[0]
    if rows % n_microbatches or (rows // n_microbatches) % dp:
        raise ValueError(f"batch {rows} does not split into "
                         f"{n_microbatches} microbatches of {dp} ranks' "
                         "rows")
    per = rows // n_microbatches
    k = per // dp
    r = mesh.index(mesh.dp_axes)
    starts = [i * per + r * k for i in range(n_microbatches)]
    return {name: torch.cat([x[s:s + k] for s in starts])
            for name, x in batch.items()}


def _sizes(cfg: LMConfig, rows: int) -> dict:
    """The global sizes ``shard`` checks, for ``rows`` global batch rows."""
    sizes = {"batch": rows, "heads": cfg.n_heads, "kv_heads": cfg.n_kv,
             "vocab": cfg.vocab, "embed": cfg.d_model}
    if cfg.moe is not None:
        sizes["experts"] = cfg.moe.n_routed
    return sizes


def make_sharded_train_step(cfg: LMConfig, opt: Adam, mesh,
                            n_microbatches: int = 1,
                            rsc: dict | None = None):
    """``train_step(state, opt_state, batch) -> (state, opt_state, loss)``
    on ``mesh`` (bound): ``state`` a ``ShardedLM``, ``opt_state`` Adam's
    over its blocks, ``batch`` this rank's rows (``local_batch``). Each
    local microbatch is this rank's block of the reference's global one;
    its loss and gradients are the global microbatch's mean (each rank's
    share, completed by the reductions of ``gather_params``), accumulated
    in f32 over the microbatches and divided by their count as the
    reference does; the loss returned is the global mean, equal on every
    rank. Raises if ``model`` does not divide a dimension of ``cfg`` that
    tensor parallelism splits whole (``check_tensor_parallel``)."""
    check_tensor_parallel(cfg, mesh)
    dp = mesh.axis_size(mesh.dp_axes)

    def train_step(state: ShardedLM, opt_state: dict, batch: dict):
        named = state.shards
        rows, t = batch["targets"].shape
        if rows % n_microbatches:
            raise ValueError(f"{rows} rows are not a multiple of "
                             f"{n_microbatches} microbatches")
        per = rows // n_microbatches
        gsum, lsum = None, 0.0
        with mesh_context(mesh, TRAIN_RULES, _sizes(cfg, per * dp)):
            for i in range(n_microbatches):
                mb = {k: x[i * per:(i + 1) * per] for k, x in batch.items()}
                logits = forward_sharded(state, rsc=rsc, **_fwd_kwargs(mb))
                l = sharded_cross_entropy(logits, mb["targets"],
                                          per * dp * t, mesh)
                del logits
                gs = _grads(l, named)
                lsum = lsum + l.detach()
                if n_microbatches == 1:
                    grads = dict(zip(named, gs))
                else:
                    if gsum is None:
                        gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                for k, p in named.items()}
                    for k, g in zip(named, gs):
                        gsum[k] += g.float()
                del l, gs
        if n_microbatches > 1:
            grads = {k: g.div_(n_microbatches) for k, g in gsum.items()}
        loss = mesh.all_reduce(torch.as_tensor(lsum), mesh.dp_axes) \
            / n_microbatches
        updates, opt_state = opt.update(grads, opt_state, named,
                                        shardings=state.shardings)
        del grads
        apply_updates(named, updates)
        return state, opt_state, loss

    return train_step


def make_sharded_prefill_step(cfg: LMConfig, mesh):
    """``prefill_step(state, batch) -> (logits, cache)`` on ``mesh``
    (bound), the counterpart of ``make_prefill_step`` run under
    ``DECODE_RULES`` (the reference jits its one prefill step with the
    mesh's shardings): ``state`` a ``ShardedLM`` in its training layout,
    ``batch`` this rank's rows (``local_batch``, one microbatch). Returns
    the last position's logits gathered whole over ``model`` (f32
    ``(rows, 1, vocab)``, equal on the ranks of a ``model`` line) and this
    rank's blocks of the cache, laid out as
    ``convert.lm_cache_shardings`` gives it (the reference's sanitized
    ``cache_shardings``), with ``"max_len"``: the global length of its
    sequence-split caches, here the prompt's. Raises as the train step
    does where ``model`` does not divide a dimension tensor parallelism
    splits whole (``check_tensor_parallel``)."""
    check_tensor_parallel(cfg, mesh)
    dp = mesh.axis_size(mesh.dp_axes)

    def prefill_step(state: ShardedLM, batch: dict):
        rows, t = next(iter(batch.values())).shape[:2]
        sizes = dict(_sizes(cfg, rows * dp), kv_seq=t)
        with torch.inference_mode(), \
                mesh_context(mesh, DECODE_RULES, sizes):
            logits, cache = forward_sharded(state, mode="prefill",
                                            last_only=True,
                                            **_fwd_kwargs(batch))
        cache["max_len"] = t
        return logits, cache

    return prefill_step


def make_sharded_decode_step(cfg: LMConfig, mesh):
    """``decode_step(state, cache, batch) -> (logits, cache)`` on
    ``mesh``, the counterpart of ``make_decode_step`` under
    ``DECODE_RULES``: ``cache`` this rank's blocks of a ``max_len`` cache
    (``launch.serve.sharded_graft``), ``batch`` this rank's rows' tokens
    ``(rows, 1)``. Attention reads its share of the cache's sequence and
    merges the softmax over ``model``; the next-token logits come back
    gathered whole over ``model``, the cache's blocks updated (attention
    in place, recurrent states replaced)."""
    check_tensor_parallel(cfg, mesh)
    dp = mesh.axis_size(mesh.dp_axes)

    def decode_step(state: ShardedLM, cache: dict, batch: dict):
        rows = next(iter(batch.values())).shape[0]
        sizes = dict(_sizes(cfg, rows * dp), kv_seq=cache["max_len"])
        with torch.inference_mode(), \
                mesh_context(mesh, DECODE_RULES, sizes):
            logits, new = forward_sharded(state, mode="decode", cache=cache,
                                          **_fwd_kwargs(batch))
        new["max_len"] = cache["max_len"]
        return logits, new

    return decode_step


# ------------------------------------------------------------ abstract
def abstract_state(cfg: LMConfig, opt: Adam):
    """(parameters, optimizer state) on the ``meta`` device: the shapes
    and dtypes of a cell's training state, nothing allocated. The
    parameters are the ``LM`` module, the state Adam's (f32 moments keyed
    like the parameters, the count)."""
    params = LM(cfg, "meta")
    return params, opt.init(dict(params.named_parameters()))


def abstract_cache(cfg: LMConfig, batch: int, max_len: int,
                   ring: int | None = None) -> dict:
    """``init_cache``'s caches on the ``meta`` device (a local layer's
    ring of ``ring`` slots when given: a prefill's holds
    ``cfg.local_window``)."""
    return {"layers": [layer_cache(cfg, k, batch, max_len, "meta", ring)
                       for k in cfg.layer_plan()],
            "len": 0}
