"""HDF5 residue-graph dataset.

Reads the reference's on-disk schema (written by its graph generator,
reference `Graph.py:61-139`) and applies the reference's load-time
transforms (reference `DataSet.py:231-366`):

- node features are selected by name (or 'all'), column-stacked in list
  order, 1-D features reshaped to [N, 1] (`DataSet.py:251-256`);
- edges are direction-doubled: the stored [E, 2] index is concatenated
  with its flip, features duplicated (`DataSet.py:265-268, 289-292`);
- the default edge-feature transform maps distance d to
  ``tanh(-d/2 + 2) + 1`` in (0, 2], applied after doubling
  (`DataSet.py:96`, quirk Q3);
- precomputed clusters `clustering/<method>/depth_{0,1}` are loaded
  alongside (`DataSet.py:348-363`).

Everything here is host-side numpy — tensors are produced only by the
batcher (:mod:`deeprank_gnn_tpu_torch.data.batch`). This is the port's own
copy of ``deeprank_gnn_tpu/data/dataset.py``; ``h5py`` is imported only
inside the functions that read or write files, so the package imports
where ``h5py`` is not installed. :class:`GraphListDataSet` serves graphs
that are already in memory through the same interface.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def default_edge_transform(x: np.ndarray) -> np.ndarray:
    """Distance -> (0, 2] squashing (reference `DataSet.py:96`)."""
    return np.tanh(-x / 2.0 + 2.0) + 1.0


@dataclass
class GraphSample:
    """One residue interface graph, fully loaded and transformed."""

    mol: str
    x: np.ndarray  # [N, F] float32
    pos: np.ndarray  # [N, 3] float32
    edge_index: np.ndarray  # [2, 2E] int32, direction-doubled
    edge_attr: np.ndarray  # [2E, Fe] float32, transformed
    internal_edge_index: np.ndarray  # [2, 2Ei] int32
    internal_edge_attr: np.ndarray  # [2Ei, Fe] float32
    cluster0: Optional[np.ndarray] = None  # [N] int32
    cluster1: Optional[np.ndarray] = None  # [C0] int32
    y: Optional[float] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_features(self) -> int:
        return self.x.shape[1]


def _sizes(n, e, ie, cluster0, cluster1) -> Dict[str, int]:
    """Padding-cap inputs of one graph: node and edge counts, cluster
    counts, the largest cluster of each level (the member-table
    capacities), and for the dense layout's run-padded node slots
    (``collate_dense``) the node count with every level-0 cluster padded
    to a multiple of 8 (``np8``) and the most 8-row tiles of one cluster
    (``mt0``: no port code reads it until the tiled cluster pool is
    ported; it keeps the probe's fields those of the JAX package)."""
    c0 = c1 = m0 = m1 = mt0 = 0
    np8 = n
    if cluster0 is not None and cluster1 is not None:
        inv0 = np.unique(cluster0, return_inverse=True)[1]
        inv1 = np.unique(cluster1, return_inverse=True)[1]
        c0 = int(inv0.max()) + 1 if inv0.size else 0
        c1 = int(inv1.max()) + 1 if inv1.size else 0
        m0 = int(np.bincount(inv0).max()) if inv0.size else 0
        m1 = int(np.bincount(inv1).max()) if inv1.size else 0
        if inv0.size:
            tiles = -(-np.bincount(inv0) // 8)
            np8 = int((tiles * 8).sum())
            mt0 = int(tiles.max())
    return {"n": n, "e": e, "ie": ie, "c0": c0, "c1": c1, "m0": m0, "m1": m1,
            "np8": np8, "mt0": mt0}


def _row_sort(index: np.ndarray, attr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Edges reordered by source node (stable): per-graph row-sorted edges
    make the batched edge list globally row-sorted (collate offsets are
    increasing), which the sorted segment sum needs. Pure reordering —
    aggregation results are order-independent."""
    order = np.argsort(index[0], kind="stable")
    return np.ascontiguousarray(index[:, order]), attr[order]


def row_sorted(g: GraphSample) -> GraphSample:
    """``g`` with its interface and internal edges row-sorted, as
    :class:`HDF5DataSet` loads them (``g`` itself is left as it is)."""
    ei, ea = _row_sort(g.edge_index, g.edge_attr)
    iei, iea = _row_sort(g.internal_edge_index, g.internal_edge_attr)
    return replace(
        g, edge_index=ei, edge_attr=ea, internal_edge_index=iei, internal_edge_attr=iea
    )


class GraphListDataSet:
    """Graphs already in memory, served through the interface that
    :class:`~deeprank_gnn_tpu_torch.data.batch.GraphLoader` and
    ``NeuralNet`` read from an :class:`HDF5DataSet` (``len``, ``get``,
    ``graph_sizes``, ``get_target``). Every graph must carry its clusters
    (``cluster0`` / ``cluster1``); its edges are row-sorted here, as
    :class:`HDF5DataSet` sorts them on load."""

    def __init__(self, graphs: Sequence[GraphSample]):
        self.graphs = [row_sorted(g) for g in graphs]
        self.index_complexes = [("<memory>", g.mol) for g in self.graphs]

    def subset(self, index: Sequence[int]) -> "GraphListDataSet":
        """The graphs at positions ``index``, in that order (already
        sorted, so they are not sorted again)."""
        out = GraphListDataSet([])
        out.graphs = [self.graphs[int(i)] for i in index]
        out.index_complexes = [self.index_complexes[int(i)] for i in index]
        return out

    def __len__(self) -> int:
        return len(self.graphs)

    def get(self, index: int) -> GraphSample:
        return self.graphs[index]

    __getitem__ = get

    def graph_sizes(self, index: int) -> Dict[str, int]:
        g = self.graphs[index]
        return _sizes(
            g.num_nodes, g.edge_index.shape[1], g.internal_edge_index.shape[1],
            g.cluster0, g.cluster1,
        )

    def get_target(self, index: int) -> Optional[float]:
        return self.graphs[index].y

    def feature_dims(self) -> Tuple[int, int]:
        """(node_feature_dim, edge_feature_dim) of the first graph."""
        g = self.graphs[0]
        return g.num_features, g.edge_attr.shape[1]


_FILTER_RE = re.compile(r"(>|<|>=|<=|==|!=)\s*([-+0-9.eE]+)")


def _eval_filter_condition(value: float, cond: str) -> bool:
    """Evaluate a filter string like '<10' or '>0.2' against a value.

    The reference evals arbitrary strings (reference `DataSet.py:437-445`,
    quirk Q12); we parse the comparison grammar instead of calling eval.
    Conjunctions may be chained with 'and' / 'or'.
    """
    ops = {
        ">": lambda a, b: a > b,
        "<": lambda a, b: a < b,
        ">=": lambda a, b: a >= b,
        "<=": lambda a, b: a <= b,
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
    }

    def atom(tok: str) -> bool:
        m = _FILTER_RE.fullmatch(tok.strip())
        if not m:
            raise ValueError(f"Unsupported filter condition: {cond!r}")
        return ops[m.group(1)](value, float(m.group(2)))

    for or_part in cond.split(" or "):
        if all(atom(t) for t in or_part.split(" and ")):
            return True
    return False


class HDF5DataSet:
    """Lazy per-graph HDF5 dataset (reference `DataSet.py:91-450` API)."""

    def __init__(
        self,
        root: str = "./",
        database: Union[str, Sequence[str], None] = None,
        transform: Optional[Callable] = None,
        pre_transform: Optional[Callable] = None,
        dict_filter: Optional[Dict[str, str]] = None,
        target: Optional[str] = None,
        tqdm: bool = True,
        index: Optional[Sequence[int]] = None,
        node_feature: Union[str, Sequence[str]] = "all",
        edge_feature: Optional[Sequence[str]] = ("dist",),
        clustering_method: str = "mcl",
        edge_feature_transform: Callable = default_edge_transform,
    ):
        self.root = root
        self.database = (
            list(database) if isinstance(database, (list, tuple)) else [database]
        )
        self.transform = transform
        self.pre_transform = pre_transform
        self.target = target
        self.dict_filter = dict_filter
        self.tqdm = tqdm
        self.index = index
        self.node_feature = node_feature
        # keep the 'all' sentinel intact (list("all") would explode it
        # into characters before check_edge_feature can match it)
        if edge_feature is None or edge_feature == "all":
            self.edge_feature = edge_feature
        else:
            self.edge_feature = list(edge_feature)
        self.clustering_method = clustering_method
        self.edge_feature_transform = edge_feature_transform

        self.check_hdf5_files()
        self.check_node_feature()
        self.check_edge_feature()
        self.create_index_molecules()

    # -- integrity / feature checks (reference `DataSet.py:169-229`) ----

    def check_hdf5_files(self) -> None:
        import h5py

        remove_file = []
        for fname in self.database:
            try:
                with h5py.File(fname, "r") as f:
                    if len(f.keys()) == 0:
                        print(f"    -> {fname} is empty ")
                        remove_file.append(fname)
            except Exception as exc:  # corrupted / missing
                print(exc)
                print(f"    -> {fname} is corrupted ")
                remove_file.append(fname)
        for name in remove_file:
            self.database.remove(name)
        if not self.database:
            raise ValueError("No valid HDF5 files in database")

    def _first_mol_group(self) -> Tuple[h5py.File, h5py.Group]:
        import h5py

        f = h5py.File(self.database[0], "r")
        mol_key = list(f.keys())[0]
        return f, f[mol_key]

    def check_node_feature(self) -> None:
        f, grp = self._first_mol_group()
        self.available_node_feature = list(grp["node_data"].keys())
        f.close()
        if self.node_feature == "all":
            self.node_feature = self.available_node_feature
        else:
            self.node_feature = list(self.node_feature)
            for feat in self.node_feature:
                if feat not in self.available_node_feature:
                    raise ValueError(
                        f"Node feature {feat!r} not found in {self.database[0]}; "
                        f"available: {self.available_node_feature}"
                    )

    def check_edge_feature(self) -> None:
        f, grp = self._first_mol_group()
        self.available_edge_feature = list(grp["edge_data"].keys())
        if self.edge_feature == "all":
            # 'all' keeps only numeric features — legacy files store a
            # string-typed 'type' column that cannot stack into the
            # edge-attribute matrix
            self.edge_feature = [
                k
                for k in self.available_edge_feature
                if grp[f"edge_data/{k}"].dtype.kind in "fiub"
            ]
        f.close()
        if self.edge_feature is not None:
            for feat in self.edge_feature:
                if feat not in self.available_edge_feature:
                    raise ValueError(
                        f"Edge feature {feat!r} not found in {self.database[0]}; "
                        f"available: {self.available_edge_feature}"
                    )

    # -- indexing (reference `DataSet.py:368-407`) ----------------------

    def graph_sizes(self, index: int) -> Dict[str, int]:
        """Cheap metadata-only size probe for one graph (used by the
        loader to derive dataset-wide static padding caps)."""
        import h5py

        fname, mol = self.index_complexes[index]
        with h5py.File(fname, "r") as f5:
            grp = f5[mol]
            n = grp[f"node_data/{self.node_feature[0]}"].shape[0]
            e = 2 * grp["edge_index"].shape[0]
            ie = 2 * grp["internal_edge_index"].shape[0]
            d0 = d1 = None
            cpath = f"clustering/{self.clustering_method}"
            if cpath in grp and "depth_0" in grp[cpath]:
                d0 = grp[cpath + "/depth_0"][()]
                d1 = grp[cpath + "/depth_1"][()]
        return _sizes(n, e, ie, d0, d1)

    def get_target(self, index: int) -> Optional[float]:
        import h5py

        """Read ONLY the target scalar for one graph (no feature
        payload) — class-weight computation over a large dataset must
        not load every graph (reference `NeuralNet.py:581-594` pays a
        full DataLoader pass here)."""
        fname, mol = self.index_complexes[index]
        with h5py.File(fname, "r") as f5:
            if mol not in f5:
                return None
            grp = f5[mol]
            if self.target is None or "score" not in grp:
                return None
            if self.target not in grp["score"]:
                return None
            raw = grp["score/" + self.target][()]
            return None if raw is None else float(raw)

    def feature_dims(self) -> Tuple[int, int]:
        """(node_feature_dim, edge_feature_dim) from HDF5 shape metadata
        only; no graph payload is read (JAX ``data/dataset.py:253``). The
        device store sizes its all-padding slot from it."""
        f, grp = self._first_mol_group()
        try:
            nf = sum(
                1 if grp[f"node_data/{k}"].ndim == 1 else grp[f"node_data/{k}"].shape[1]
                for k in self.node_feature
            )
            if self.edge_feature is None:
                ef = 0
            else:
                raw = sum(
                    1 if grp[f"edge_data/{k}"].ndim == 1 else grp[f"edge_data/{k}"].shape[1]
                    for k in self.edge_feature
                )
                ef = self.edge_feature_transform(np.zeros((1, raw), dtype=np.float32)).shape[1]
        finally:
            f.close()
        return nf, ef

    def create_index_molecules(self) -> None:
        import h5py

        self.index_complexes: List[Tuple[str, str]] = []
        for fdata in self.database:
            try:
                with h5py.File(fdata, "r") as fh5:
                    if self.index is None:
                        mol_names = list(fh5.keys())
                    else:
                        all_names = list(fh5.keys())
                        mol_names = [all_names[i] for i in self.index]
                    for k in mol_names:
                        if self.filter(fh5[k]):
                            self.index_complexes.append((fdata, k))
            except Exception as inst:
                print("\t\t--> Ignore File : " + str(fdata))
                print(inst)
        self.ntrain = len(self.index_complexes)
        self.index_train = list(range(self.ntrain))
        self.ntot = len(self.index_complexes)

    def filter(self, molgrp: h5py.Group) -> bool:
        if self.dict_filter is None:
            return True
        for cond_name, cond_vals in self.dict_filter.items():
            try:
                val = molgrp["score"][cond_name][()]
            except KeyError:
                print(f"   :Filter {cond_name} not found for mol {molgrp}")
                print("   :Filter options are")
                for k in molgrp["score"].keys():
                    print("   : ", k)
                continue
            if isinstance(cond_vals, str):
                if not _eval_filter_condition(float(val), cond_vals):
                    return False
            else:
                raise ValueError("Conditions not supported", cond_vals)
        return True

    # -- loading --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.index_complexes)

    len = __len__

    def get(self, index: int) -> Optional[GraphSample]:
        fname, mol = self.index_complexes[index]
        data = self.load_one_graph(fname, mol)
        if data is not None and self.transform is not None:
            data = self.transform(data)
        return data

    __getitem__ = get

    def _stack_features(
        self, grp: h5py.Group, sub: str, names: Sequence[str]
    ) -> np.ndarray:
        cols = []
        for feat in names:
            vals = grp[f"{sub}/{feat}"][()]
            if vals.ndim == 1:
                vals = vals.reshape(-1, 1)
            cols.append(vals)
        return np.hstack(cols)

    def _load_edges(
        self, grp: h5py.Group, index_key: str, data_key: str
    ) -> Tuple[np.ndarray, np.ndarray]:
        ind = grp[index_key][()]
        # tolerate legacy (0,)-shaped empty edge lists
        ind = ind.reshape(-1, 2)
        # direction-doubling: (i,j) AND (j,i) (reference `DataSet.py:265-268`)
        ind = np.vstack((ind, np.flip(ind, 1))).T.astype(np.int32)
        if self.edge_feature is not None:
            attr = self._stack_features(grp, data_key, self.edge_feature)
            attr = np.vstack((attr, attr))
            attr = self.edge_feature_transform(attr).astype(np.float32)
        else:
            attr = np.zeros((ind.shape[1], 0), dtype=np.float32)
        return _row_sort(ind, attr)

    def load_one_graph(self, fname: str, mol: str) -> Optional[GraphSample]:
        import h5py

        with h5py.File(fname, "r") as f5:
            if mol not in f5:
                return None
            grp = f5[mol]
            try:
                x = self._stack_features(grp, "node_data", self.node_feature)
                x = x.astype(np.float32)
            except Exception:
                print("node attributes not found in the file", fname)
                return None
            try:
                edge_index, edge_attr = self._load_edges(
                    grp, "edge_index", "edge_data"
                )
                iedge_index, iedge_attr = self._load_edges(
                    grp, "internal_edge_index", "internal_edge_data"
                )
            except Exception:
                print("edge features not found in the file", fname)
                return None

            y = None
            if self.target is not None and "score" in grp:
                if self.target in grp["score"]:
                    raw = grp["score/" + self.target][()]
                    if raw is not None:
                        y = float(raw)

            pos = grp["node_data/pos"][()].astype(np.float32)

            cluster0 = cluster1 = None
            cpath = f"clustering/{self.clustering_method}"
            if (
                cpath in grp
                and "depth_0" in grp[cpath]
                and "depth_1" in grp[cpath]
            ):
                cluster0 = grp[cpath + "/depth_0"][()].astype(np.int32)
                cluster1 = grp[cpath + "/depth_1"][()].astype(np.int32)
            else:
                print("WARNING: no cluster detected")

            return GraphSample(
                mol=mol,
                x=x,
                pos=pos,
                edge_index=edge_index,
                edge_attr=edge_attr,
                internal_edge_index=iedge_index,
                internal_edge_attr=iedge_attr,
                cluster0=cluster0,
                cluster1=cluster1,
                y=y,
            )


def DivideDataSet(
    dataset: HDF5DataSet, percent=(0.8, 0.2), shuffle: bool = True,
    seed: Optional[int] = None,
) -> Tuple[HDF5DataSet, HDF5DataSet]:
    """Split into train / eval index views (reference `DataSet.py:14-42`).

    Unlike the reference (which shuffles with the *global* numpy RNG and
    is therefore unreproducible run-to-run), pass ``seed`` for a
    deterministic split. A :class:`GraphListDataSet` splits into two of
    its subsets.
    """
    size = len(dataset)
    index = np.arange(size)
    if shuffle:
        np.random.default_rng(seed).shuffle(index)
    size1 = int(percent[0] * size)
    index1, index2 = index[:size1], index[size1:]
    if isinstance(dataset, GraphListDataSet):
        return dataset.subset(index1), dataset.subset(index2)

    dataset1 = copy.copy(dataset)
    dataset1.index_complexes = [dataset.index_complexes[i] for i in index1]
    dataset2 = copy.copy(dataset)
    dataset2.index_complexes = [dataset.index_complexes[i] for i in index2]
    return dataset1, dataset2


def PreCluster(dataset: HDF5DataSet, method: str) -> None:
    """Compute and store two-level node clusters into the source HDF5.

    Mirrors the reference's offline pre-clustering (reference
    `DataSet.py:45-88`, quirk Q8: this *writes into the input files*,
    and drops unloadable graphs). Clustering runs on internal edges
    only; depth_1 clusters the max-pooled graph.
    """
    import h5py

    from deeprank_gnn_tpu_torch.featurize.cluster import (
        community_detection,
        pool_graph_host,
    )

    for fname, mol in list(dataset.index_complexes):
        data = dataset.load_one_graph(fname, mol)
        if data is None:
            with h5py.File(fname, "a") as f5:
                if mol in f5:
                    print(f"deleting {mol}")
                    del f5[mol]
                else:
                    print(f"{mol} not found")
            dataset.index_complexes.remove((fname, mol))
            continue

        cluster0 = community_detection(
            data.internal_edge_index, data.num_nodes, method=method
        )
        pooled_iedge_index, pooled_num_nodes = pool_graph_host(
            cluster0, data.internal_edge_index
        )
        cluster1 = community_detection(
            pooled_iedge_index, pooled_num_nodes, method=method
        )

        with h5py.File(fname, "a") as f5:
            grp = f5[mol]
            clust_grp = grp.require_group("clustering")
            if method.lower() in clust_grp:
                print(f"Deleting previous data for mol {mol} method {method}")
                del clust_grp[method.lower()]
            method_grp = clust_grp.create_group(method.lower())
            method_grp.create_dataset("depth_0", data=cluster0.astype(np.int64))
            method_grp.create_dataset("depth_1", data=cluster1.astype(np.int64))
