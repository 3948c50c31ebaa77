"""The public signatures of every ported module against its JAX twin.

For each module of carla_ppo_tpu_torch with a namesake in carla_ppo_tpu,
every public function, and every public method of a public class, that
both define is compared parameter by parameter, so that a call written
against the JAX API binds the same way on the port. Only the torch idioms
are allowed to differ:
- a torch.Generator (`generator`, or `noise`, which takes a generator or
  the draw itself) where JAX takes a key (`rng`, `key`), also where the
  JAX state carries its key (EnvState.rng);
- a torch module holding its parameters (`model`, or a module argument)
  where JAX passes a parameter tree (`params`, `variables`,
  `vae_variables`), and torch's construction arguments of a module: flax's
  `parent` / `name` are gone, input sizes are named (`obs_dim`, `n_in`,
  `in_dim`, `in_channels`, `z_dim` of a decoder) and flax's `dtype`
  field is `compute_dtype`;
- a `dp` group where JAX takes a mesh and an axis name;
- `device`;
- the per-function lists below: settings that JAX compiles in and the
  port takes where they are used, and JAX settings the port does not take,
  each with its reason.
What is checked, with those renamed or dropped on both sides: every JAX
parameter exists in the port, the ones both have come in the same order,
and a port-only parameter without a default is an idiom.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import pkgutil

import pytest

import carla_ppo_tpu_torch

# JAX parameter -> the port's name for it (None: dropped, the module holds it).
JAX_IDIOMS = {"rng": "generator", "key": "generator", "params": None, "variables": None,
              "vae_variables": None, "opt_state": "optimizer", "mesh": "dp", "axis_name": "dp",
              "parent": None, "name": None, "dtype": "compute_dtype", "self": None}
# Port parameters that stand for a torch idiom and need no JAX twin.
PORT_IDIOMS = {"generator", "noise", "model", "vae", "dp", "device", "batch", "obs_dim", "n_in",
               "in_dim", "in_channels", "z_dim", "self"}
# Where JAX compiles a setting into the function it builds and the port's
# eager code takes it where it is used, or JAX passes a state whose module
# the port takes: per function, the JAX parameters that the port takes
# elsewhere.
ELSEWHERE = {
    # the returned iteration takes freeze and rollout_model at each call
    "make_dp_train_iteration": {"rollout_model", "with_freeze"},
    "make_dp_pixel_train_iteration": {"with_freeze"},
    # the port's state holds no optax chain; pixel_update reads the clips
    "create_pixel_train_state": {"pix"},
    # the port takes the TrainState's model (and the VAE module)
    "warm_start_from_vae": {"train_state"},
}
# JAX parameters that the port does not take, because no value but the
# default is used and the port keeps it as a constant, or because the
# setting has no effect in the port.
NOT_TAKEN = {
    # the losses take beta and kl_tolerance as arguments, in both packages
    # (the VAE module never reads its own); the MLP sizes are every
    # caller's defaults, kept as MlpEncoder.SIZES / MlpDecoder.SIZES
    "VAE.__init__": {"beta", "kl_tolerance", "encoder_sizes", "decoder_sizes"},
    "MlpEncoder.__init__": {"hidden_sizes"},
    "MlpDecoder.__init__": {"hidden_sizes"},
    # the module's dtype is forward()'s `dtype` argument in the port
    "MLP.__init__": {"dtype"},
    "ConvEncoder.__init__": {"dtype"},
    # JAX's choice between its C++ and Python A*, which give one route;
    # the port has one A*
    "compute_route_waypoints": {"use_native"},
}
# Per function, a JAX parameter the port names for what it is.
RENAMED = {
    # JAX replicates any pytree; the port replicates a TrainState
    "replicate": {"tree": "train_state"},
}


def _port_modules():
    names = [m.name for m in pkgutil.walk_packages(carla_ppo_tpu_torch.__path__,
                                                   "carla_ppo_tpu_torch.")]
    pairs = []
    for name in sorted(names):
        twin = "carla_ppo_tpu" + name[len("carla_ppo_tpu_torch"):]
        try:
            importlib.util.find_spec(twin)
        except ModuleNotFoundError:
            continue
        if importlib.util.find_spec(twin) is not None:
            pairs.append((name, twin))
    return pairs


PAIRS = _port_modules()


def _callables(port_mod, jax_mod):
    """(qualified name, port callable, JAX callable) for every public name
    both modules define (classes: __init__ and their shared public
    methods)."""
    out = []
    for attr, obj in sorted(vars(port_mod).items()):
        if attr.startswith("_") or getattr(obj, "__module__", None) != port_mod.__name__:
            continue
        twin = getattr(jax_mod, attr, None)
        if twin is None or not callable(obj) or not callable(twin):
            continue
        if inspect.isclass(obj):
            for meth in ["__init__"] + sorted(vars(obj)):
                if meth.startswith("_") and meth != "__init__":
                    continue
                a, b = getattr(obj, meth, None), getattr(twin, meth, None)
                if callable(a) and callable(b) and not inspect.isclass(a):
                    out.append((f"{attr}.{meth}", a, b))
        else:
            out.append((attr, obj, twin))
    return out


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return None


def signature_gaps(port_fn, jax_fn, elsewhere=frozenset(), renamed=None) -> list[str]:
    port, jax = _params(port_fn), _params(jax_fn)
    idioms = {**JAX_IDIOMS, **(renamed or {})}
    if port is None or jax is None:
        return []
    port_names = [p.name for p in port if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    jax_names = []
    for p in jax:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or p.name in elsewhere:
            continue
        # A name the port keeps is compared as it is (`params` of an env
        # function is EnvParams in both); else the idiom's rename applies.
        mapped = p.name if p.name in port_names else idioms.get(p.name, p.name)
        if mapped is not None and mapped not in jax_names:
            jax_names.append(mapped)
    gaps = [f"missing {n!r}" for n in jax_names
            if n not in port_names and n not in PORT_IDIOMS]
    shared = [n for n in jax_names if n in port_names and n not in PORT_IDIOMS]
    if [n for n in port_names if n in shared] != shared:
        gaps.append(f"order {[n for n in port_names if n in shared]} vs JAX {shared}")
    takes_kwargs = any(p.kind == p.VAR_KEYWORD for p in jax)
    for p in port:
        if (p.default is p.empty and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
                and p.name not in jax_names and p.name not in PORT_IDIOMS and not takes_kwargs):
            gaps.append(f"required port-only {p.name!r}")
    return gaps


@pytest.mark.parametrize("port_name, jax_name", PAIRS, ids=[p for p, _ in PAIRS])
def test_public_signatures_match_jax(port_name, jax_name):
    port_mod = importlib.import_module(port_name)
    jax_mod = importlib.import_module(jax_name)
    gaps = {}
    for qual, a, b in _callables(port_mod, jax_mod):
        found = signature_gaps(a, b, ELSEWHERE.get(qual, set()) | NOT_TAKEN.get(qual, set()),
                               RENAMED.get(qual))
        if found:
            gaps[qual] = found
    assert gaps == {}


def test_the_check_catches_a_missing_parameter():
    """The C5 fault: a port function without JAX's second parameter."""
    def port(images, seed=0):
        pass

    def jax(images, val_portion=0.1, seed=0):
        pass

    assert signature_gaps(port, jax) == ["missing 'val_portion'"]
    assert signature_gaps(lambda images, val_portion=0.1, seed=0, device="cuda": 0, jax) == []
