"""Core library: the paper's contribution (ASD for DDPMs), the JAX
package's ``repro.core`` names on the port's modules.

The names load on first use (PEP 562): ``kernels.grs.ops`` imports
``core.grs``, and ``core.verifier`` imports ``kernels.grs.ops``, so an
eager re-export here would close an import cycle."""

import importlib

# each exported name and the module of repro_torch.core that holds it
_HOMES = {
    "Schedule": "schedules",
    "sl_uniform": "schedules",
    "sl_geometric": "schedules",
    "ddpm": "schedules",
    "ddpm_coeffs": "schedules",
    "ou_time_of_sl": "schedules",
    "sl_time_of_ou": "schedules",
    "sl_of_ddpm_state": "schedules",
    "ddpm_of_sl_state": "schedules",
    "grs": "grs",
    "grs_reject_prob": "grs",
    "verify": "verifier",
    "leading_true_count": "verifier",
    "sequential_sample": "sequential",
    "sequential_sample_with_noise": "sequential",
    "init_y0": "sequential",
    "ASDChainState": "asd",
    "ASDResult": "asd",
    "RoundPlan": "asd",
    "plan_round": "asd",
    "commit_round": "asd",
    "asd_round": "asd",
    "asd_sample": "asd",
    "asd_superstep": "asd",
    "asd_sample_batched": "asd",
    "asd_init_y0": "asd",
    "chain_done": "asd",
    "chain_sample": "asd",
    "init_chain_state": "asd",
    "ThetaController": "controller",
    "StaticTheta": "controller",
    "AIMDTheta": "controller",
    "AcceptRateTheta": "controller",
    "CONTROLLERS": "controller",
    "make_controller": "controller",
    "BranchController": "controller",
    "StaticBranches": "controller",
    "GainBranches": "controller",
    "BRANCH_CONTROLLERS": "controller",
    "make_branch_controller": "controller",
    "GMM": "analytic",
    "default_gmm": "analytic",
    "sl_mean_fn": "analytic",
    "ddpm_x0_fn": "analytic",
}

__all__ = list(_HOMES)


def __getattr__(name):
    if name not in _HOMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOMES[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
