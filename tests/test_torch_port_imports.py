"""Import hygiene of the port: torcheasyrec_tpu_torch and chip_smoke.py
import neither JAX nor the JAX package, and both packages' protos load
side by side and parse the same config text."""

import ast
import importlib.util
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
from google.protobuf import text_format

from torch_port_helpers import hstu_synth_config_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _is_forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "torcheasyrec_tpu"
            or name.startswith("torcheasyrec_tpu."))


def test_forbidden_prefix_spares_the_port():
    assert _is_forbidden("jax") and _is_forbidden("jax.numpy")
    assert _is_forbidden("torcheasyrec_tpu")
    assert _is_forbidden("torcheasyrec_tpu.ops.hstu")
    assert not _is_forbidden("torcheasyrec_tpu_torch")
    assert not _is_forbidden("torcheasyrec_tpu_torch.ops.hstu")
    assert not _is_forbidden("jaxlib_like_name")


def test_port_imports_no_jax():
    code = inspect.getsource(_is_forbidden) + """
import importlib, pkgutil, sys
import torcheasyrec_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
assert len(names) > 20, names
for name in ("benchmark.synthetic", "models.dbmtl", "modules.mmoe",
             "modules.extraction_net", "modules.interaction",
             "modules.sequence", "models.multi_tower",
             "models.rocket_launching", "datasets.sampler",
             "models.match_model", "models.dssm", "models.dat",
             "modules.capsule", "models.mind", "modules.gr.preprocessors",
             "models.ultra_hstu", "models.hstu_match",
             "modules.variational_dropout", "modules.personalized_net",
             "modules.intervention", "losses.pe_mtl_loss", "models.xdeepfm",
             "models.wukong", "models.pepnet", "models.dc2vr",
             "tools.feature_selection", "acc.quant_util", "export",
             "tools.hitrate", "utils.test_util",
             "utils.delta_embedding_dump", "utils.shm_pack", "models.tdm",
             "tools.tdm.gen_tree", "tools.tdm.retrieval",
             "utils.dist_util", "parallel.mesh", "parallel.planner",
             "parallel.zch", "parallel.host_spill", "utils.summary_util",
             "tools.dynamicemb.create_zch_init_ckpt",
             "tools.dynamicemb.convert_zch_ckpt", "datasets.csv_dataset",
             "modules.sid.quantizer", "models.sid_models",
             "utils.sid.collision", "utils.sid.quality",
             "tools.sid.resolve_sid_collisions",
             "tools.sid.evaluate_sid_quality", "fg", "fg.dag",
             "features.other_features", "features.spiece",
             "benchmark.fg_synth", "tools.create_fg_json",
             "tools.create_online_infer_data"):
    assert pkg.__name__ + "." + name in names, name
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if _is_forbidden(m))
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


# the modules of the DeepFM slice: each is found by the walk above (it is
# a module of the package) and names no forbidden import, and not the
# repo's JAX benchmark script either, anywhere in its source
DEEPFM_SLICE_MODULES = [
    "ops.row_write", "parallel.emb_engine", "modules.embedding",
    "modules.fm", "models.rank_model", "models.deepfm", "metrics", "losses",
    "main", "eval", "train_eval", "utils.convert",
    # the data layer and the checkpointed training loop
    "datasets.utils", "datasets.dataset", "datasets.parquet_dataset",
    "utils.checkpoint_util", "utils.config_util", "predict",
    # the Criteo ranking and multi-task zoo
    "benchmark.synthetic", "models.wide_and_deep", "models.dlrm",
    "models.dcn", "models.masknet", "models.multi_task_rank",
    "models.mmoe", "models.ple", "models.dbmtl", "modules.interaction",
    "modules.masknet", "modules.mmoe", "modules.extraction_net",
    # the sequence layer and the rest of the criteo_synth zoo
    "modules.sequence", "models.multi_tower", "models.rocket_launching",
    # two-tower retrieval and the negative samplers
    "datasets.sampler", "models.match_model", "models.dssm", "models.dat",
    "modules.capsule", "models.mind",
    # the generative-recommendation family
    "modules.gr.preprocessors", "modules.gr.stu", "modules.gr.hstu_transducer",
    "models.ultra_hstu", "models.hstu_match",
    # the rest of the ranking and multi-task zoo
    "modules.activation", "modules.mlp", "modules.module",
    "modules.variational_dropout", "modules.personalized_net",
    "modules.intervention", "losses.pe_mtl_loss", "models.xdeepfm",
    "models.wukong", "models.pepnet", "models.dc2vr", "models.model",
    "tools.feature_selection",
    # export and artifact serving
    "acc.quant_util", "export", "tools.hitrate", "utils.test_util",
    "utils.delta_embedding_dump",
    # TDM and the shared sampler tables
    "utils.shm_pack", "models.tdm", "tools.tdm.gen_tree",
    "tools.tdm.retrieval",
    # training over several ranks
    "utils.dist_util", "parallel.mesh", "parallel.planner",
    # feature generation from raw columns
    "fg", "fg.dag", "features.feature", "features.id_feature",
    "features.raw_feature", "features.other_features", "features.spiece",
    "datasets.data_parser", "benchmark.fg_synth", "tools.create_fg_json",
    "tools.create_online_infer_data",
]


@pytest.mark.parametrize("module", DEEPFM_SLICE_MODULES)
def test_deepfm_slice_module_imports_no_jax(module):
    spec = importlib.util.find_spec(f"torcheasyrec_tpu_torch.{module}")
    assert spec is not None and spec.origin
    names = _imported_names(spec.origin)
    bad = [n for n in names if _is_forbidden(n) or n == "bench"]
    assert not bad, bad


def test_row_write_kernel_source_ships_with_the_package():
    """The wrapper builds ``csrc/row_write.cu`` at first use; its C entry
    point carries 64-bit row counts (a 30 M-row table of 512-byte rows
    passes 2^32 bytes)."""
    from torcheasyrec_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "row_write.cu").read_text()
    assert 'extern "C" int row_write(' in src
    assert "long long k, long long p" in src and "size_t" in src


def test_fg_ops_source_ships_with_the_package():
    """The FG library builds from the port's own ``fg/csrc/fg_ops.cc``
    into the port's build directory; its task layout is the one
    ``fg/dag.py`` declares (the DAG and the sequence split-hash entry
    points among it)."""
    from torcheasyrec_tpu_torch import fg

    assert fg.CSRC.parent.parent == Path(fg.__file__).resolve().parent
    src = fg.CSRC.read_text()
    for entry in ("int fg_run_dag(FgTask* tasks", "fg_seq_split_hash(",
                  "int64_t fg_split_hash(", "void fg_hash64_ints_mod("):
        assert entry in src, entry
    assert fg.library_path().parent.name == "build"
    assert fg.library_path().parent.parent.name == "torcheasyrec_tpu_torch"


def test_chip_smoke_imports_no_jax():
    names = _imported_names(os.path.join(REPO, "chip_smoke.py"))
    assert "torcheasyrec_tpu_torch" in names
    bad = [n for n in names if _is_forbidden(n) or n == "bench"]
    assert not bad, bad


def test_both_packages_protos_parse_one_text():
    from torcheasyrec_tpu.protos import pipeline_pb2 as jax_pb2
    from torcheasyrec_tpu_torch.protos import pipeline_pb2 as port_pb2

    text = hstu_synth_config_text(8)
    a = text_format.Parse(text, jax_pb2.EasyRecConfig())
    b = text_format.Parse(text, port_pb2.EasyRecConfig())
    assert b.DESCRIPTOR.full_name == "tzrec_tpu_torch.protos.EasyRecConfig"
    assert a.SerializePartialToString() == b.SerializePartialToString()
    assert b.model_config.dlrm_hstu.hstu.stu.embedding_dim == 128
