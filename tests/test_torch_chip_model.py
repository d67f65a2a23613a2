"""The port's ASTRA chip model and per-request accounting against the
reference's, on the CPU.

``core/{photonics,energy,mapping,simulator,baselines}.py`` are the port's
own copies of the reference's pure-Python modules: on every config the
repo defines (the paper's five models and the ten served architectures,
full size and reduced) ``simulate``, ``compare_all`` and the op graphs
must give exactly the reference's floats, as must ``map_matmul``, the
photonic budget and ``request_hardware_report`` (prefix-cached tokens
billed at zero).  ``validate_site_registry`` passes on every config whose
stack the port serves and agrees with the reference on every config.  A
served request's ``hardware`` equals the reference engine's for the same
request, on dense caches and on the paged pool with and without a
prefix hit; ``astra_accounting=False`` leaves it ``None``.  Also the
paper's claims the reference's ``tests/test_hardware_model.py`` asserts,
through the port.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import mapping as jmap  # noqa: E402
from repro.core import photonics as jphot  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.accounting import request_hardware_report as jax_report  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import ARCHS, PAPER_MODELS, PAPER_SEQ_LEN, get_arch  # noqa: E402
from repro_torch.core import baselines, energy, mapping, photonics, plan, simulator  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import PORTED_KINDS  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.accounting import request_hardware_report  # noqa: E402

CHIP, JCHIP = energy.AstraChipConfig(), jenergy.AstraChipConfig()
CONFIGS = list(PAPER_MODELS) + list(ARCHS)


def _cfgs(name, reduced):
    t, j = get_arch(name), jax_get_arch(name)
    return (t.reduced(), j.reduced()) if reduced else (t, j)


def _report(rep):
    """A ModelReport as plain values (the classes differ by package)."""
    return (rep.name, rep.latency_s, rep.energy_j, rep.macs,
            [(c.name, c.latency_s, c.energy_j, c.macs, c.passes, c.adc_convs)
             for c in rep.op_costs])


def _ops(mm, ew):
    return ([dataclasses.astuple(o) for o in mm], [dataclasses.astuple(o) for o in ew])


# every config at full size, and each served architecture's reduced form
SIZED = [(n, False) for n in CONFIGS] + [(n, True) for n in ARCHS]


@pytest.mark.parametrize("name,reduced", SIZED,
                         ids=[f"{n}-{'reduced' if r else 'full'}" for n, r in SIZED])
def test_simulate_and_compare_all_equal_reference(name, reduced):
    cfg, jcfg = _cfgs(name, reduced)
    for seq, batch in ((PAPER_SEQ_LEN.get(name, 128), 1), (7, 3)):
        assert _ops(*simulator.model_ops(cfg, seq, batch)) == _ops(*jsim.model_ops(jcfg, seq,
                                                                                   batch))
        got = [_report(r) for r in baselines.compare_all(cfg, CHIP, seq, batch)]
        want = [_report(r) for r in jbase.compare_all(jcfg, JCHIP, seq, batch)]
        assert got == want
        assert simulator.simulate(cfg, CHIP, seq, batch).energy_per_mac_j == \
            jsim.simulate(jcfg, JCHIP, seq, batch).energy_per_mac_j


@pytest.mark.parametrize("name", CONFIGS)
def test_site_registry_equals_reference(name):
    """Every executed GEMM site maps to one simulator op on every served
    stack the port runs; elsewhere the check fails or passes as the
    reference's does."""
    cfg, jcfg = _cfgs(name, False)
    outcome = []
    for fn, c in ((plan.validate_site_registry, cfg), (jplan.validate_site_registry, jcfg)):
        try:
            fn(c)
            outcome.append("ok")
        except AssertionError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    if name in ARCHS and all(k in PORTED_KINDS for k in cfg.layer_kinds):
        assert outcome[0] == "ok"
    for op in [o.name for o in simulator.model_ops(cfg, 4)[0]] + ["lm_head", "L12.kv.k"]:
        assert plan.site_class(op) == jplan.site_class(op)


def test_mapping_and_photonics_equal_reference():
    ops = [("s", 64, 512, 64, True, False, 1), ("x", 32, 4096, 16, True, False, 1),
           ("qk", 8, 64, 300, True, True, 12), ("w", 3, 5 * 2**20, 16, False, False, 2)]
    for op in ops:
        got = mapping.map_matmul(CHIP, mapping.MatmulOp(*op))
        want = jmap.map_matmul(JCHIP, jmap.MatmulOp(*op))
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    got = mapping.map_elementwise(CHIP, mapping.ElementwiseOp("n", 12345))
    assert dataclasses.astuple(got) == dataclasses.astuple(
        jmap.map_elementwise(JCHIP, jmap.ElementwiseOp("n", 12345)))
    assert CHIP.component_pass_energy_j() == JCHIP.component_pass_energy_j()
    assert (CHIP.energy_per_mac_j(), CHIP.peak_macs_per_s, CHIP.laser_wall_power_w) == (
        JCHIP.energy_per_mac_j(), JCHIP.peak_macs_per_s, JCHIP.laser_wall_power_w)
    p, jp = photonics.PhotonicParams(), jphot.PhotonicParams()
    assert photonics.vdpe_scalability_table(p) == jphot.vdpe_scalability_table(jp)
    for n in (2, 64, 1024, 4096):
        assert photonics.snr_db(p, n) == jphot.snr_db(jp, n)
        assert photonics.max_lanes_at_power(p, n * 1e-4) == jphot.max_lanes_at_power(jp, n * 1e-4)
    assert photonics.electrons_per_bit(p) == jphot.electrons_per_bit(jp)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen1.5-0.5b", "recurrentgemma-2b",
                                  "opt-350m", "granite-moe-1b-a400m", "xlstm-125m"])
def test_request_hardware_report_equals_reference(name):
    cfg, jcfg = _cfgs(name, False)
    for prompt, gen, cached in ((1, 0, 0), (17, 9, 0), (384, 32, 256), (64, 16, 64),
                                (5, 1, 4)):
        got = request_hardware_report(cfg, CHIP, prompt, gen, cached)
        want = jax_report(jcfg, JCHIP, prompt, gen, cached)
        assert got.as_dict() == want.as_dict()
        assert got.cached_prompt_tokens == cached and got.prompt_tokens == prompt


@pytest.mark.parametrize("model", list(PAPER_MODELS))
def test_paper_claims_hold_in_the_port(model):
    """>= 7.6x speedup against the best accelerator, >= 1.3x less energy
    than every accelerator and > 1000x less than CPU/GPU/TPU (the
    reference's own assertions, here on the port's modules)."""
    cfg = get_arch(model)
    seq = PAPER_SEQ_LEN[cfg.name]
    astra = simulator.simulate(cfg, CHIP, seq=seq)
    accels = [baselines.simulate_baseline(s, cfg, seq) for n, s in baselines.BASELINES.items()
              if n not in ("cpu", "gpu", "tpu")]
    assert min(a.latency_s for a in accels) / astra.latency_s >= 7.6
    for n, spec in baselines.BASELINES.items():
        ratio = baselines.simulate_baseline(spec, cfg, seq).total_energy_j / astra.total_energy_j
        if n in ("cpu", "gpu", "tpu"):
            assert ratio > 1000.0, (n, ratio)
        else:
            assert ratio >= 1.3, (n, ratio)


@pytest.fixture(scope="module")
def arch():
    jcfg = dataclasses.replace(jax_get_arch("stablelm-1.6b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch("stablelm-1.6b").reduced(), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(1))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("bs", [0, 4], ids=["dense", "paged"])
def test_served_hardware_equals_reference_engine(arch, bs):
    """Each served request's report equals the reference engine's: three
    prompts, then two that share the first's 12-token prefix (on the pool,
    cache hits billed at zero) and a request with no new tokens."""
    jcfg, tcfg, jparams, tparams = arch
    rng = np.random.default_rng(3)
    first = [rng.integers(0, jcfg.vocab, n, dtype=np.int32) for n in (13, 6, 9)]
    second = [np.concatenate([first[0][:12], rng.integers(0, jcfg.vocab, n, dtype=np.int32)])
              for n in (3, 7)]
    kw = dict(max_slots=2, max_len=24, chunk_steps=3, kv_block_size=bs)
    engines = (JaxServeEngine(JaxModel(jcfg), jparams, JaxServeConfig(**kw)),
               ServeEngine(Model(tcfg, device="cpu"), tparams, ServeConfig(**kw), device="cpu"))
    reports = []
    for eng in engines:
        outs = eng.generate_batch(first, 5) + eng.generate_batch(second, 4)
        outs += eng.generate_batch(first[:1], 0)
        reports.append([(o.tokens.tolist(), o.hardware.as_dict()) for o in outs])
    assert reports[1] == reports[0]
    cached = [hw["cached_prompt_tokens"] for _, hw in reports[1]]
    assert cached == ([0] * 6 if bs == 0 else [0, 0, 0, 12, 12, 0])
    off = ServeEngine(Model(tcfg, device="cpu"), tparams,
                      ServeConfig(astra_accounting=False, **kw), device="cpu")
    assert off.generate_batch(first[:1], 2)[0].hardware is None
