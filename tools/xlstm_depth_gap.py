"""How far a bf16 xLSTM lies from its fp32 self at depth, in both packages.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_depth_gap.py \
        [--d-model 256] [--layers 24] [--vocab 4096] [--batch 4] [--tokens 48]

xlstm-350m's config at a reduced width (its depth, heads and xLSTM
settings kept), the reference's ``init`` in bf16 and upcast to fp32, the
same weights carried into the port: each package decodes the same tokens
one by one from a fresh cache, and the tool prints, per package, the
largest |bf16 − fp32| logit gap over the steps, then the two packages'
gaps to each other in fp32 and in bf16, and each package's bf16 prefill
against its own bf16 decode chain.  A CPU comparison tool, like
``tools/bsr_ref_gap.py``: it imports both packages; the port does not.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.models.api import build_model
from repro_torch.models.convert import lm_params_from_jax


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=48)
    args = ap.parse_args(argv)
    over = dict(d_model=args.d_model, n_layers=args.layers, vocab=args.vocab)
    jcfg = dataclasses.replace(jreg.get_config("xlstm-350m"), **over)
    cfg = dataclasses.replace(registry.get_config("xlstm-350m"), **over)
    jm = jax_build_model(jcfg)
    p16 = jm.init(jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
    b, s = args.batch, args.tokens
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s)).astype(np.int32)
    dec = jax.jit(jm.decode_step)

    def ref_chain(params):
        cache, out = jm.init_cache(b, 0), []
        for t in range(s):
            logits, cache = dec(params, cache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                                "pos": jnp.asarray(t, jnp.int32)})
            out.append(np.asarray(logits, np.float32))
        return np.concatenate(out, 1)

    def port(params):
        return lm_params_from_jax(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, params))

    def port_chain(model):
        cache, out = model.init_cache(b, 0), []
        with torch.no_grad():
            for t in range(s):
                logits, cache = model.decode_step(cache, {
                    "tokens": torch.from_numpy(toks[:, t:t + 1]).long(), "pos": torch.tensor(t)})
                out.append(logits.float().numpy())
        return np.concatenate(out, 1)

    gap = lambda a, c: float(np.abs(a - c).max())  # noqa: E731
    r16, r32 = ref_chain(p16), ref_chain(p32)
    m16 = port(p16)
    t16, t32 = port_chain(m16), port_chain(port(p32))
    print(f"xlstm-350m at d_model {args.d_model}, {args.layers} layers, vocab {args.vocab}; "
          f"{b} x {s} tokens decoded one by one; max |fp32 logit| {np.abs(r32).max():.3f}")
    per_step = np.abs(r16 - r32).max(axis=(0, 2))
    print(f"reference bf16 vs its fp32: max {gap(r16, r32):.4f}, per step from "
          f"{per_step.min():.4f} to {per_step.max():.4f}")
    per_step = np.abs(t16 - t32).max(axis=(0, 2))
    print(f"port bf16 vs its fp32: max {gap(t16, t32):.4f}, per step from "
          f"{per_step.min():.4f} to {per_step.max():.4f}")
    print(f"port vs reference: fp32 {gap(t32, r32):.4f}, bf16 {gap(t16, r16):.4f}")
    jlog, _ = jax.jit(jm.prefill)(p16, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlog, _ = m16.prefill({"tokens": torch.from_numpy(toks).long()})
    print(f"bf16 prefill vs the bf16 decode chain's last logits: reference "
          f"{gap(np.asarray(jlog, np.float32)[:, 0], r16[:, -1]):.4f}, port "
          f"{gap(tlog.float().numpy()[:, 0], t16[:, -1]):.4f}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
