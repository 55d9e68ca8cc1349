"""The port stands alone: no module of `src/repro_torch/`, nor
`chip_smoke.py`, the port's examples (`examples/*_torch.py`) or
scripts (`scripts/*_torch.py`), imports `jax`, `ml_dtypes` or the JAX
package `repro`."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py")) \
    + sorted((ROOT / "scripts").glob("*_torch.py"))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path}: imports {mod}"


SUBPROCESS_CODE = """
import sys
sys.modules["jax"] = None          # `import jax` now raises ImportError
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
from repro_torch.core import power_iteration, simple_pagerank
from repro_torch.graphs import erdos_renyi
g = erdos_renyi(40, 4.0, seed=1, device="cpu")
pi, _, _ = power_iteration(g, 0.2, device="cpu")
for engine in ("walks", "counts"):
    r = simple_pagerank(g, 0.2, walks_per_node=4, engine=engine, device="cpu")
    assert abs(r.pi.sum() - 1.0) < 0.3 and r.logical_rounds > 0
from repro_torch import prng
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import distributed_pagerank
from repro_torch.core.distributed_counts import distributed_pagerank_counts
from repro_torch.launch.pagerank import run
mesh = StackedMesh(3, "cpu")
r = distributed_pagerank(g, 0.2, 4, prng.PRNGKey(0), mesh=mesh)
assert r.dropped == 0 and r.rounds > 0
r = distributed_pagerank_counts(g, 0.2, 4, prng.PRNGKey(0), mesh=mesh)
assert r.residual == 0 and r.rounds > 0
import datetime, tempfile
import torch.distributed as dist
from repro_torch.core.collectives import ProcessGroupMesh
dist.init_process_group("gloo", store=dist.FileStore(tempfile.mktemp(), 1),
                        rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=60))
one = ProcessGroupMesh(device="cpu")
r1 = distributed_pagerank_counts(g, 0.2, 4, prng.PRNGKey(0), mesh=one)
r0 = distributed_pagerank_counts(g, 0.2, 4, prng.PRNGKey(0),
                                 mesh=StackedMesh(1, "cpu"))
assert r1.shards == 1 and r1.zeta.tolist() == r0.zeta.tolist()
dist.destroy_process_group()
from repro_torch.core import directed_local_pagerank, improved_pagerank
from repro_torch.core.distributed_directed import \
    distributed_directed_pagerank
from repro_torch.core.distributed_improved import \
    distributed_improved_pagerank
for fn in (improved_pagerank, directed_local_pagerank):
    assert fn(g, 0.2, walks_per_node=4, device="cpu").coupons_used > 0
for fn in (distributed_improved_pagerank, distributed_directed_pagerank):
    r = fn(g, 0.2, 4, prng.PRNGKey(0), mesh=mesh)
    assert r.residual == 0 and r.dropped == 0 and r.phase3_rounds == 1
for algo in ("walks", "counts", "improved", "directed"):
    assert run(40, 0.2, 4, "directed_web", None, [2], algo=algo, shards=2,
               device="cpu").restarts == 1
from repro_torch.core.personalized import personalized_pagerank
from repro_torch.core.personalized_batch import \
    batched_personalized_pagerank
from repro_torch.serve import PPRService
assert personalized_pagerank(g, 0.2, [0, 3], 200, device="cpu").sum() > 0
r = batched_personalized_pagerank(g, 0.2, [([0], None), ([5, 6], None)],
                                  100, prng.PRNGKey(1), mesh=mesh)
assert r.dropped == 0 and r.ppr.shape == (2, 40)
svc = PPRService(g, 0.2, slots=2, walks_per_query=50, mesh=mesh)
req = svc.submit([1], now=0.0)
svc.drain(now=1.0)
svc.resize(shards=2)
assert req.done and svc.submit([1], now=2.0).cached
assert run(40, 0.2, 4, "directed_web", None, [], algo="ppr", shards=2,
           device="cpu").shape == (4, 40)
import repro_torch.analysis
from repro_torch.analysis.congest import audit_all_engines, format_wire_table
from repro_torch.graphs.partition import (degree_balanced_relabel,
                                          shard_load_stats)
g2, perm = degree_balanced_relabel(g, 3)
assert g2.n == 42 and sorted(perm.tolist()) != [] and shard_load_stats(g2, 3)
import numpy as np
from repro_torch.configs import reduced_config
from repro_torch.models import get_model
from repro_torch.serve import ContinuousBatcher, Request
for arch in ("qwen2-7b", "deepseek-v2-236b"):
    cfg = reduced_config(arch)
    model = get_model(cfg)(cfg, device="cpu", seed=0)
    reqs = [Request(rid=i, prompt=np.arange(5 + i, dtype=np.int32),
                    max_new_tokens=3) for i in range(2)]
    stats = ContinuousBatcher(model, slots=2, max_seq=16).run(reqs)
    assert stats.completed == 2 and stats.tokens_out == 6
from repro_torch.data import DataConfig, PageRankWeightedSampler
from repro_torch.launch.train import run_training
from repro_torch.train import compressed_psum
_, state, losses = run_training(reduced_config("mamba2-1.3b"), steps=2,
                                global_batch=2, seq_len=8, device="cpu")
assert len(losses) == 2 and int(state.step) == 2
b = PageRankWeightedSampler(np.ones(40), DataConfig(
    vocab_size=16, seq_len=4, global_batch=2)).batch_at(0)
assert b["tokens"].shape == (2, 4)
import torch
y, _ = compressed_psum(torch.ones(3, 5), mesh, torch.zeros(3, 5))
assert y.shape == (5,)
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import make_stacked_mesh
from repro_torch.models.moe import moe_forward_sharded
from repro_torch.sharding import ShardingRules, default_rules
r = trace_cell(reduced_config("qwen2-7b"), ShapeConfig("t", 8, 2, "train"),
               device="cpu")
assert r["flops"] > 0 and r["peak_bytes"] > r["argument_bytes"] > 0
cfg = reduced_config("dbrx-132b")
layer = get_model(cfg)(cfg, device="cpu", seed=0).moe_layers[0].moe
rules = ShardingRules(make_stacked_mesh({"data": 2, "model": 2}, "cpu"),
                      default_rules(False))
out, aux = moe_forward_sharded(layer, torch.ones(2, 4, cfg.d_model,
                                                 dtype=torch.bfloat16),
                               cfg, rules)
assert out.shape == (2, 4, cfg.d_model) and float(aux) > 0
assert not {"jax", "ml_dtypes"} & {m.split(".")[0]
                                    for m, v in sys.modules.items() if v}
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SUBPROCESS_CODE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
