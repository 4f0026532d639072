"""How far the JAX package's own float32 autoencoder step lands from its
float64 step: the reference for ``chip_smoke.py`` phase 13's f32 check.

    JAX_PLATFORMS=cpu python tests/jax_ae_f32_shares.py

One step of ``mimm_tpu.train.ae.make_ae_train_step`` (Adam at 1e-4) on
the full-width ResNetAE (256², 6 levels, 2 residual blocks, z_dim 192,
bottleneck 768) at B=8, from JAX's random weights, in float32 and in
float64 from the same weights, on the uint8 batch phase 13 draws
(``default_rng(35)``).  Prints, per parameter group (encoder, decoder,
fc1/fc2), the largest |Δ| between the two updated states, the share of
elements that moved apart by more than 1e-6, and the share whose step
took the other sign, and |Δloss|, as one JSON line.  A script, not a
test (~5 minutes on the CPU).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

IMG, B, LR = 256, 8, 1e-4
CONFIG = dict(input_shape=(IMG, IMG, 1), n_residual_blocks=2, n_levels=6,
              z_dim=192, bottleneck_dim=768)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def main():
    import jax
    import jax.numpy as jnp

    from mimm_tpu.models.autoencoder import ResNetAE
    from mimm_tpu.train.ae import AETrainState, make_ae_train_step
    from mimm_tpu.train.optim import adam_torch

    images = np.random.default_rng(35).integers(0, 256, (B, IMG, IMG, 1),
                                                dtype=np.uint8)
    v32 = jax.device_get(ResNetAE(**CONFIG).init(
        jax.random.PRNGKey(1), jnp.zeros((1, IMG, IMG, 1)), train=False))
    tx = adam_torch(LR)

    def step(dtype, params, stats):
        state = AETrainState(params, stats, tx.init(params),
                             jnp.zeros([], jnp.int32))
        state, loss = make_ae_train_step(ResNetAE(**CONFIG, dtype=dtype), tx)(
            state, jnp.asarray(images))
        return float(loss), _flat(jax.device_get(state.params))

    l32, p32 = step(jnp.float32, v32["params"], v32["batch_stats"])
    with jax.enable_x64(True):
        up = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
        l64, p64 = step(jnp.float64, up(v32["params"]),
                        up(v32["batch_stats"]))
    p0 = _flat(v32["params"])
    out = {"loss_diff": abs(l32 - l64)}
    for group in ("encoder", "decoder", "fc"):
        keys = [k for k in p0 if k.startswith(group)]
        d = np.concatenate([np.abs(p32[k] - p64[k]).ravel() for k in keys])
        flips = np.concatenate([(np.sign(p32[k] - p0[k])
                                 != np.sign(p64[k] - p0[k])).ravel()
                                for k in keys])
        out[group] = {"max_abs": float(d.max()),
                      "share_1e-6": float((d > 1e-6).mean()),
                      "flip_share": float(flips.mean()), "n": int(d.size)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
