"""Port parity, the init representations (GAE / VGAE / ARGVA, SVGAE, GIC),
and the runner's routes for them, ScaLed, node2vec and the heuristics.

With the JAX package's weights carried across by ``models/convert.py`` and
fixed negatives, the GAE encoders, the reconstruction loss and one Adam step
match within 1e-5. SVGAE's ``log_iv``, ``bessel_ratio`` and ``vmf_kl``
match the JAX package's within 1e-5 relative and scipy at the bars of
tests/test_models_extra.py:224-260; the vMF sampler's rows are unit-norm,
their mean cosine lies within 4 standard errors of I_{m/2}/I_{m/2-1}, and
its Beta draw passes a KS test. GIC's 5-epoch loss trace (the
step-only-when-not-improving quirk included) and embeddings match the JAX
package's from the same weights and shuffles within 1e-4. A GAE-initialized
PoS run learns, and the runner takes each of those configs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats
from scipy.special import gammaln, ive

import s3grl_tpu.models.gae as jgae
import s3grl_tpu.models.gic as jgic
import s3grl_tpu.models.svgae as jsvgae
import s3grl_tpu_torch.models.gae as tgae
import s3grl_tpu_torch.models.gic as tgic
import s3grl_tpu_torch.models.svgae as tsvgae
from s3grl_tpu.data.graph import Graph as JGraph
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.models.convert import gae_state_dict_from_jax, svgae_state_dict_from_jax
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, random_edges, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOL = dict(rtol=1e-5, atol=1e-5)
N, F = 80, 6


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n=N, e=200)
    x = rng.normal(size=(N, F)).astype(np.float32)
    return rng, ei, x


@pytest.mark.parametrize("model", ["GAE", "VGAE", "ARGVA"])
def test_gae_encode_loss_and_adam_step_match_jax(model):
    rng, ei, x = _graph(1)
    variational = model != "GAE"
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    names = ("w1", "w_mu", "w_ls") if variational else ("w1", "w2")
    shapes = {"w1": (F, 8), "w2": (8, 16), "w_mu": (8, 16), "w_ls": (8, 16)}
    params = {k: jgae._glorot(keys[i], shapes[k]) for i, k in enumerate(names)}
    es, ed, w = jgae._gcn_norm_edges(ei.astype(np.int64), N)
    neg = rng.integers(0, N, (2, ei.shape[1]))
    pos_j, neg_j = jnp.asarray(ei), jnp.asarray(neg)

    def loss_fn(p):
        z = jgae._encode(p, es, ed, w, jnp.asarray(x), N, variational)[0]
        return jgae._recon_loss(z, pos_j[0], pos_j[1], neg_j[0], neg_j[1])

    zj = jgae._encode(params, es, ed, w, jnp.asarray(x), N, variational)[0]
    lj, gj = jax.value_and_grad(loss_fn)(params)
    tx = optax.adam(0.01)
    upd, _ = tx.update(gj, tx.init(params))
    stepped = optax.apply_updates(params, upd)

    enc = tgae.GCNAutoEncoder(F, 8, 16, variational, generator=torch.Generator())
    enc.load_state_dict(gae_state_dict_from_jax({k: np.asarray(v) for k, v in params.items()}))
    edges = tgae._gcn_norm_edges(ei, N)
    # The weights bit for bit, in the edge list's order (by destination).
    order = np.argsort(np.asarray(ed), kind="stable")
    np.testing.assert_array_equal(edges.by_dst.weight.numpy(), np.asarray(w)[order])
    z = enc(edges, torch.as_tensor(x))[0]
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(zj), **TOL)
    pos_t, neg_t = torch.as_tensor(ei).long(), torch.as_tensor(neg)
    loss = tgae._recon_loss(z, pos_t[0], pos_t[1], neg_t[0], neg_t[1])
    np.testing.assert_allclose(loss.item(), float(lj), **TOL)
    opt = torch.optim.Adam(enc.parameters(), lr=0.01)
    loss.backward()
    opt.step()
    for k in names:
        np.testing.assert_allclose(getattr(enc, k).detach().numpy(), np.asarray(stepped[k]),
                                   **TOL, err_msg=k)


KAPPA = np.array([0.5, 1.0, 5.0, 20.0, 80.0, 300.0, 650.0, 1000.0])


@pytest.mark.parametrize("m", [9, 17, 65, 129])
def test_vmf_numerics_match_jax_and_scipy(m):
    nu = m / 2.0 - 1.0
    k_j, k_t = jnp.asarray(KAPPA, jnp.float32), torch.as_tensor(KAPPA, dtype=torch.float32)
    ratio = tsvgae.bessel_ratio(nu + 1.0, k_t).numpy()
    logiv = tsvgae.log_iv(nu, k_t).numpy()
    kl = tsvgae.vmf_kl(k_t, m).numpy()
    np.testing.assert_allclose(ratio, np.asarray(jsvgae.bessel_ratio(nu + 1.0, k_j)), rtol=1e-5)
    np.testing.assert_allclose(logiv, np.asarray(jsvgae.log_iv(nu, k_j)), rtol=1e-5)
    # The KL sums log C_m and log Area, each up to 130 in size at m = 129,
    # where a float32 ulp is 1.5e-5: a KL near 0 agrees to 4 such ulps, not
    # 1e-5 relative.
    np.testing.assert_allclose(kl, np.asarray(jsvgae.vmf_kl(k_j, m)), rtol=1e-5, atol=6e-5)
    # tests/test_models_extra.py:224-260's scipy bars.
    ref_ratio = ive(nu + 1.0, KAPPA) / ive(nu, KAPPA)
    np.testing.assert_allclose(ratio, ref_ratio, rtol=1e-4)
    ref_logiv = np.log(ive(nu, KAPPA)) + KAPPA
    np.testing.assert_allclose(logiv, ref_logiv, rtol=0, atol=2e-4 if m >= 33 else 2e-3)
    ref_kl = (KAPPA * ref_ratio
              + (nu * np.log(KAPPA) - (nu + 1) * np.log(2 * np.pi) - ref_logiv)
              + (np.log(2.0) + (m / 2.0) * np.log(np.pi) - gammaln(m / 2.0)))
    np.testing.assert_allclose(kl, ref_kl, rtol=3e-3, atol=1e-3)
    assert (kl >= -1e-4).all()


@pytest.mark.parametrize("kappa", [2.0, 50.0])
def test_vmf_sampler_law(kappa):
    n, m = 4000, 17
    gen = torch.Generator().manual_seed(0)
    mu = torch.randn((n, m), generator=gen)
    mu = mu / torch.linalg.norm(mu, dim=1, keepdim=True)
    z = tsvgae.vmf_sample(mu, torch.full((n, 1), kappa), gen)
    np.testing.assert_allclose(torch.linalg.norm(z, dim=1).numpy(), 1.0, atol=1e-5)
    cos = (z * mu).sum(dim=1).numpy().astype(np.float64)
    expect = ive(m / 2.0, kappa) / ive(m / 2.0 - 1.0, kappa)
    assert abs(cos.mean() - expect) < 4 * cos.std() / np.sqrt(n)
    draws = tsvgae.beta_symmetric(m - 1, (20000,), gen, "cpu").numpy()
    assert stats.kstest(draws, stats.beta(8.0, 8.0).cdf).pvalue > 0.01


def test_svgae_encoder_carries_the_jax_weights():
    _, ei, x = _graph(2)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    params = {"w1": jgae._glorot(keys[0], (F, 64)), "w_mu": jgae._glorot(keys[1], (64, 9)),
              "w_kap": jgae._glorot(keys[2], (64, 1))}
    enc = tsvgae.SVGAEEncoder(F, 9, generator=torch.Generator())
    enc.load_state_dict(svgae_state_dict_from_jax({k: np.asarray(v) for k, v in params.items()}))
    edges = tgae._gcn_norm_edges(ei, N)
    z, mu, kappa = enc(edges, torch.as_tensor(x), torch.Generator().manual_seed(0))
    es, ed, w = jgae._gcn_norm_edges(ei.astype(np.int64), N)
    h = jax.nn.relu(jsvgae.spmm(es, ed, w, jnp.asarray(x) @ params["w1"], N))
    mu_j = jsvgae.spmm(es, ed, w, h @ params["w_mu"], N)
    mu_j = mu_j / jnp.linalg.norm(mu_j, axis=1, keepdims=True)
    kap_j = jax.nn.softplus(jsvgae.spmm(es, ed, w, h @ params["w_kap"], N))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(kappa.detach().numpy(), np.asarray(kap_j), **TOL)
    assert z.shape == (N, 9)


class _RecordingJax:
    """``jax`` for the JAX package's gic module, recording each jitted
    ``loss_and_step``'s loss and ``embed``'s first parameters."""

    def __init__(self, losses, first_params):
        self._losses, self._first = losses, first_params

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jf = jax.jit(fn)

        def recorded(*args):
            out = jf(*args)
            if fn.__name__ == "loss_and_step":
                self._losses.append(float(out[0]))
            elif fn.__name__ == "embed" and not self._first:
                self._first.update({k: np.asarray(v) for k, v in args[0].items()})
            return out

        return recorded


def test_gic_loss_trace_matches_jax(monkeypatch):
    rng, ei, x = _graph(3)
    tv = tuple(rng.integers(0, N, (2, 30)) for _ in range(4))
    kw = dict(embedding_dim=16, epochs=5, lr=0.05, seed=4)
    j_losses, init = [], {}
    monkeypatch.setattr(jgic, "jax", _RecordingJax(j_losses, init))
    _, j_embs = jgic.run_gic(JGraph(num_nodes=N, edge_index=ei, x=x), ei, tv, **kw)
    # The fixed cluster init, drawn as run_gic draws it (gic.py:98-112).
    k = jax.random.split(jax.random.PRNGKey(4), 6)
    init["mu_init"] = np.asarray(jax.random.uniform(k[2], (10, 16)))

    t_losses = []
    loss_of = tgic.gic_loss

    def recorded(*args):
        out = loss_of(*args)
        t_losses.append(out.item())
        return out

    monkeypatch.setattr(tgic, "gic_loss", recorded)
    _, t_embs = tgic.run_gic(Graph(num_nodes=N, edge_index=ei, x=x), ei, tv,
                             init_params=init, device="cpu", **kw)
    assert len(t_losses) == len(j_losses) == 5
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=1e-4)
    # Epochs that improve the best loss do not step: the trace holds some.
    assert any(b < a for a, b in zip(j_losses, j_losses[1:]))
    np.testing.assert_allclose(t_embs, j_embs, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def usair_split():
    rng, _ = seed_everything(1)
    return do_edge_split(Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng)


SMALL = dict(
    dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
    init_features="degree", use_feature=True, sign_k=2, node_label="zo",
    pool_operatorwise=True, hidden_channels=32, batch_size=32, lr=1e-3, num_hops=1,
    seed=1, extract_batch_size=64, max_subgraph_nodes=256, subgraph_buckets=(64, 256),
    delete_dataset=True,
)


def test_gae_pos_learns(usair_split, tmp_path):
    """configs/paper/initrep.json's Cora_PoS_GAE at test size, degree
    features standing in for Cora's attributes, with
    tests/test_models_extra.py:113's bar: best test AUC > 55."""
    graph, split = usair_split
    cfg = RunConfig(**SMALL, init_representation="GAE", epochs=3, train_percent=50.0,
                    val_percent=50.0, test_percent=50.0, results_dir=str(tmp_path))
    _, best, _, _, _ = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert best > 55.0


RUNNER_PATHS = {
    "n2v": dict(init_features="n2v", n2v_dim=8),
    "ScaLed": dict(m=3, M=5, num_hops=0),
    "ScaLed-Plus": dict(m=3, M=5, num_hops=0, k_heuristic=1,
                        k_node_set_strategy="intersection", k_pool_strategy="mean"),
    "ScaLed-hybrid": dict(m=3, M=5, num_hops=0, sign_type="hybrid"),
    "GAE": dict(init_representation="GAE"),
    "VGAE": dict(init_representation="VGAE"),
    "ARGVA": dict(init_representation="ARGVA"),
    "SVGAE": dict(init_representation="SVGAE"),
    "GIC": dict(init_representation="GIC"),
    "CN": dict(use_heuristic="CN"),
    "AA": dict(use_heuristic="AA"),
    "PPR": dict(use_heuristic="PPR"),
}


@pytest.mark.parametrize("name", list(RUNNER_PATHS))
def test_runner_takes_the_init_walk_and_heuristic_configs(usair_split, name, tmp_path, monkeypatch):
    monkeypatch.setenv("S3GRL_TPU_SVGAE_EPOCHS", "20")
    graph, split = usair_split
    cfg = RunConfig(**{**SMALL, **RUNNER_PATHS[name]}, epochs=1, train_percent=5.0,
                    val_percent=20.0, test_percent=20.0, results_dir=str(tmp_path))
    _, best, ttimes, _, _ = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert np.isfinite(best)
    assert (0.0 < best <= 1.0) if cfg.use_heuristic else (best > 0.0 and len(ttimes) == 1)
    # No path turns on a global deterministic mode.
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("fields,what", [
    (dict(model="WalkPool", node_label="drnl", max_nodes_per_hop=5), "WalkPool"),
    (dict(profile=True, ratio_per_hop=0.5), "profile"),
    (dict(dataset="ogbl-collab", max_nodes_per_hop=5), "OGB"),
    (dict(m=3, M=5, optimize_sign=False, node_label="drnl"), "ScaLed rw sampling"),
])
def test_what_is_not_ported_still_raises(usair_split, fields, what, tmp_path):
    """The WalkPool, profile and OGB routes run now; each still refuses
    per-hop sampling, which is not ported, and the full-row flow refuses
    ScaLed's walks, as in the JAX package."""
    graph, split = usair_split
    cfg = RunConfig(**{**SMALL, **fields, "results_dir": str(tmp_path)})
    match = what if what == "ScaLed rw sampling" else "per-hop sampling"
    with pytest.raises(NotImplementedError, match=match):
        run_sgrl_learning(cfg, graph, split, device="cpu")
