"""Write the JAX package's initial weights of a preset as a port state_dict.

    python tests/make_jax_init.py converge_bev OUT.pt [SEED]
    python tests/make_jax_init.py converge_bev_fusion OUT.pt [SEED]

The weights are those ``ddp_tpu.train.loop.train`` starts from (``init``,
not jitted as the loop calls it, on the first batch of ``make_train_iter``,
keys split from ``PRNGKey(runtime.seed)``, or from ``PRNGKey(SEED)`` where
given), carried across by ``ddp_tpu_torch/convert.py``.
``python tests/train_from_start.py PRESET --init OUT.pt`` then
trains the port's end check from the JAX run's start, which separates a
difference of the packages from the spread over random starts. Runs on the
CPU (it imports JAX, as the port's tests do; the port itself never does).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddp_tpu import config as jconfig  # noqa: E402
from ddp_tpu.data import make_train_iter  # noqa: E402
from ddp_tpu_torch.config import build_model, get_config  # noqa: E402
from ddp_tpu_torch.convert import load_flax  # noqa: E402


def main(preset: str, out: str, seed: str = "") -> None:
    jcfg = jconfig.get_config(preset)
    if seed:
        jcfg = jconfig.get_config(preset, {"runtime.seed": int(seed)})
    model = jconfig.build_model(jcfg.model)
    rig = ("image", "cam2lidar_rots", "cam2lidar_trans", "intrins", "post_rots", "post_trans")
    keys = {"bev": rig + ("label",), "bev_fusion": rig + ("voxel_feats", "rulebooks", "label")
            }.get(jcfg.model.task, ("image", "label"))
    init_rng, _ = jax.random.split(jax.random.PRNGKey(jcfg.runtime.seed))
    batch0 = next(make_train_iter(jcfg))
    first = [jax.tree_util.tree_map(lambda x: jnp.asarray(x[:1]), batch0[k]) for k in keys]
    variables = model.init({"params": init_rng, "diffusion": jax.random.PRNGKey(1),
                            "dropout": jax.random.PRNGKey(2)}, *first, train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_model(get_config(preset).model, device="cpu")
    load_flax(port, variables["params"], variables.get("batch_stats"))
    torch.save({k: v.clone() for k, v in port.state_dict().items()}, out)
    print(f"wrote {out}: the JAX package's initial {preset} weights")


if __name__ == "__main__":
    main(*sys.argv[1:4])
