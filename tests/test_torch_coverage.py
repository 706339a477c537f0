"""The port covers the JAX package's public API.

Every public function, class, public method of a public class and keyword
parameter of ``deeprank_gnn_tpu/`` must have a counterpart of the same name
in the same module of ``deeprank_gnn_tpu_torch/`` (``data/dense_batch.py``
to ``data/dense_batch.py``), or stand in ``STAND_INS`` with the port's
stand-in or the reason none is needed. Both packages are read as source
with ``ast``: nothing is imported, JAX included.

An entry is ``module:name``, ``module:Class.method``, or a keyword parameter
``module:function(param)`` (a class's parameters are its ``__init__``'s).
A stand-in names a port entry in the same notation, which must exist, or is
``None`` with a reason.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = ROOT / "deeprank_gnn_tpu"
PORT_PACKAGE = ROOT / "deeprank_gnn_tpu_torch"

_MODULES = "the nn.Module holds the parameters and draws them in its constructor"
_FORWARD = "forward: the module's own parameters, dropout from its generator"
_PROBE = ("a probe of the Pallas kernels' windows or availability: the CUDA wrappers check "
          "their own inputs and raise, and there is no fallback to probe for")

# JAX entry -> (port stand-in or None, why)
STAND_INS = {
    # the parameter pytrees and init / apply -> nn.Modules
    "models/foutnet:FoutLayerParams": ("models/foutnet:FoutLayer", _MODULES),
    "models/foutnet:FoutNetParams": ("models/foutnet:FoutNet", _MODULES),
    "models/foutnet:FoutNet.init": ("models/foutnet:FoutNet", _MODULES),
    "models/foutnet:FoutNet.apply": ("models/common:SingleTowerNet.forward", _FORWARD),
    "models/ginet:GINetConvParams": ("models/ginet:GINetConvLayer", _MODULES),
    "models/ginet:GINetParams": ("models/ginet:GINet", _MODULES),
    "models/ginet:GINet.init": ("models/ginet:GINet", _MODULES),
    "models/ginet:GINet.apply": ("models/ginet:GINet.forward", _FORWARD),
    "models/sgat:SGATLayerParams": ("models/sgat:SGATLayer", _MODULES),
    "models/sgat:SGATParams": ("models/sgat:sGAT", _MODULES),
    "models/sgat:sGAT.init": ("models/sgat:sGAT", _MODULES),
    "models/sgat:sGAT.apply": ("models/common:SingleTowerNet.forward", _FORWARD),
    "models/common:uniform_init(rng)": ("models/common:uniform_init(generator)",
                                        "a torch.Generator"),
    "models/common:uniform_init(dtype)": (None, "the tensor's .to(dtype)"),
    "models/common:linear_init(rng)": ("models/common:linear_init(generator)",
                                       "a torch.Generator"),
    "models/common:linear_init(dtype)": (None, "the tensors' .to(dtype)"),
    "models/common:dropout(rng)": ("models/common:dropout(generator)", "a torch.Generator"),
    "models/foutnet:fout_layer(params)": ("models/foutnet:fout_layer(layer)", "the layer module"),
    "models/foutnet:fout_layer(sorted_rows)": ("models/foutnet:fout_layer(row_ptr)",
                                               "CSR row pointers of the sorted rows"),
    "models/ginet:ginet_conv(params)": ("models/ginet:ginet_conv(conv)", "the layer module"),
    "models/ginet:ginet_conv(sorted_rows)": ("models/ginet:ginet_conv(row_ptr)",
                                             "CSR row pointers of the sorted rows"),
    "models/sgat:sgat_layer(params)": ("models/sgat:sgat_layer(layer)", "the layer module"),
    "models/sgat:sgat_layer(sorted_rows)": ("models/sgat:sgat_layer(row_ptr)",
                                            "CSR row pointers of the sorted rows"),
    # the native library -> torch geometry on the featurizer's device
    "native:get_lib": (None, "no native library: the geometry is torch on the featurizer's "
                             "device (featurize/geometry.py)"),
    "native:sasa_native": ("featurize/geometry:sasa", "torch on the featurizer's device"),
    "native:contact_pairs_native": ("featurize/geometry:contact_pairs",
                                    "torch on the featurizer's device"),
    "native:coalesce_pairs_native": ("featurize/geometry:coalesce_pairs",
                                     "torch on the featurizer's device"),
    # the Pallas kernels -> the CUDA kernels' wrappers
    "ops/pallas/__init__:fused_gin_conv": ("ops/kernels/gin_conv:fused_gin_conv", "K3"),
    "ops/pallas/segment:sorted_segment_sum": ("ops/kernels/segment:sorted_segment_sum", "K1"),
    "ops/pallas/segment:sorted_scatter_gather": (
        "ops/kernels/scatter_gather:sorted_scatter_gather", "K2"),
    "ops/pallas/segment:required_window": (None, _PROBE),
    "ops/pallas/segment:sorted_window_ok": (None, _PROBE),
    "ops/pallas/segment:pallas_fused_available": (None, _PROBE),
    "ops/pallas/segment:pallas_sorted_available": (None, _PROBE),
    "ops/segment:segment_sum_jit": ("ops/segment:segment_sum", "eager PyTorch has no jit"),
    "ops/segment:segment_sum(sorted_ids)": ("ops/segment:segment_sum(row_ptr)",
                                            "CSR row pointers of the sorted ids"),
    "ops/segment:segment_mean(sorted_ids)": ("ops/segment:segment_mean(row_ptr)",
                                             "CSR row pointers of the sorted ids"),
    # the multi-device layer: ranks of a process group instead of shardings
    "parallel/halo:make_halo_mesh": ("parallel/mesh:make_halo_mesh", "beside make_mesh"),
    "parallel/halo:halo_specs": (None, "PartitionSpecs of a sharded HaloBatch: each rank "
                                       "holds its own part of the batch"),
    "parallel/halo:fout_apply_halo": ("parallel/halo:single_tower_pooled_halo",
                                      "FoutNet.forward dispatches there"),
    "parallel/halo:sgat_apply_halo": ("parallel/halo:single_tower_pooled_halo",
                                      "sGAT.forward dispatches there"),
    "parallel/halo:ginet_apply_halo(params)": ("parallel/halo:ginet_apply_halo(model)",
                                               "the module"),
    "parallel/halo:ginet_apply_halo(rng)": ("parallel/halo:ginet_apply_halo(generator)",
                                            "a torch.Generator"),
    "parallel/halo:ginet_apply_halo(training)": (None, "the module's own training flag"),
    "parallel/hlo_bytes:collective_bytes": ("parallel/collectives:collective_bytes",
                                            "counted as the collectives run"),
    "parallel/hlo_bytes:activation_collective_bytes": (
        "parallel/collectives:collective_bytes", "counted as the collectives run, by role"),
    "parallel/mesh:batch_shardings": (None, "NamedShardings of a batch: a rank holds its own "
                                            "slice (shard_batch)"),
    "parallel/mesh:dense_batch_shardings": (None, "NamedShardings of a batch: a rank holds its "
                                                  "own slice (shard_dense_batch)"),
    "parallel/mesh:make_mesh(devices)": ("parallel/mesh:make_mesh(ranks)",
                                         "the process group's ranks"),
    "parallel/mesh:shard_batch(batch)": ("parallel/mesh:shard_batch(graphs)",
                                         "a rank collates only its graphs"),
    # the dense collate's layout knob: the run-padded layout is the port's only one
    "data/dense_batch:collate_dense(cluster_sort)": (
        None, "only the JAX package's tests pass False; its loaders and store, like the "
              "port's, always build the run-padded layout"),
    # the device store: the store's device is set when it is built
    "data/device_store:ChunkedGraphStore.upload(device)": (None, "the store's own device"),
    "data/device_store:build_store_from_loader(device)": (None, "the loader's device"),
    # compiled executables and checkpoints
    "train/aot:AotCachedFunction": ("train/aot:use_executable_cache",
                                    "the hand kernels' built libraries are the executables"),
    "train/checkpoint:torch_state_dict_to_params": (None, "the port's modules load the "
                                                          "reference state dict as it is"),
    "train/checkpoint:adam_state_from_torch": (None, "torch.optim.Adam loads a torch Adam "
                                                     "state dict as it is"),
    "train/checkpoint:adapt_opt_state": ("train/checkpoint:adam_state_from_checkpoint",
                                         "either checkpoint flavour's Adam state"),
    "train/checkpoint:params_from_checkpoint": ("train/checkpoint:state_dict_from_checkpoint",
                                                "either checkpoint flavour's weights"),
    "train/scan:make_epoch_steps": ("train/scan:EpochSteps", "captured CUDA graphs of steps"),
    "train/scan:make_train_scan": ("train/scan:EpochSteps", "captured CUDA graphs of steps"),
}


def _params(fn) -> set:
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls") and not x.arg.startswith("_")}


def public_api(root: Path) -> dict:
    """``{entry: keyword parameters}`` of every public top-level function
    and class of ``root``'s modules and every public method of such a
    class (a class's parameters are its ``__init__``'s)."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        mod = path.relative_to(root).with_suffix("").as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not (
                    node.name.startswith("_")):
                out[f"{mod}:{node.name}"] = _params(node)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                out[f"{mod}:{node.name}"] = set()
                for sub in node.body:
                    if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        continue
                    if sub.name == "__init__":
                        out[f"{mod}:{node.name}"] = _params(sub)
                    elif not sub.name.startswith("_"):
                        out[f"{mod}:{node.name}.{sub.name}"] = _params(sub)
    return out


def entries(api: dict) -> set:
    """Every entry of ``api``, its keyword parameters included."""
    return set(api) | {f"{k}({p})" for k, params in api.items() for p in params}


JAX_API = public_api(JAX_PACKAGE)
PORT_API = public_api(PORT_PACKAGE)
JAX_MODULES = sorted({k.split(":")[0] for k in JAX_API})


def gaps(jax_api: dict, port_api: dict) -> list:
    """The JAX entries without a counterpart of the same module and name
    in the port, whether or not ``STAND_INS`` covers them."""
    port = entries(port_api)
    return sorted(e for e in entries(jax_api) if e not in port
                  and not (e.endswith(")") and e.split("(")[0] not in port))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_covered(module):
    """Each JAX module's entries have a counterpart or a stand-in."""
    mine = {k: v for k, v in JAX_API.items() if k.split(":")[0] == module}
    missing = [e for e in gaps(mine, PORT_API) if e not in STAND_INS]
    assert not missing, f"no counterpart in deeprank_gnn_tpu_torch and no stand-in: {missing}"


def test_stand_ins_are_needed_and_exist():
    """Each stand-in entry is a JAX entry that the port lacks (a stale one
    fails), and the port entry it names exists."""
    jax_entries, port_entries = entries(JAX_API), entries(PORT_API)
    all_gaps = set(gaps(JAX_API, PORT_API))
    for entry, (port, why) in STAND_INS.items():
        assert entry in jax_entries, f"{entry} is not in the JAX package"
        assert entry in all_gaps, f"{entry} has a counterpart now; drop its stand-in"
        assert port is None or port in port_entries, f"{entry}: {port} is not in the port"
        assert why, entry


def test_api_read_from_both_packages():
    """The walk finds both packages' entry points and their keyword
    parameters, and a JAX entry with no counterpart shows as a gap."""
    for api in (JAX_API, PORT_API):
        assert {"data/dense_batch:collate_dense", "models/ginet:GINet",
                "train/neuralnet:NeuralNet"} <= set(api)
        assert {"precompute_ops", "g_pad"} <= api["data/dense_batch:collate_dense"]
    assert "data/dense_batch:collate_dense(cluster_sort)" in gaps(JAX_API, PORT_API)


def test_port_imports_no_jax():
    """No module of the port imports JAX or the JAX package."""
    for path in sorted(PORT_PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "deeprank_gnn_tpu"), (path, name)
