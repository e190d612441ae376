"""DBoW2 `ORBvoc.txt` vocabulary import.

Counterpart of `covins_tpu/ops/dbow_import.py`.  The reference backend
loads the ORB-SLAM2/3 vocabulary tree at startup
(`covins_backend/src/covins_backend/backend.cpp:411-429`,
`include/covins/covins_base/vocabulary.h:44`; text format parsed by
`thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338-1421`).  Importing the
same file lets retrieval behavior be A/B'd against the reference instead
of depending on a self-trained vocabulary.

Text format (per the reference parser):
    line 0:   ``k L scoring_type weighting_type``
    line i:   ``parent_id is_leaf d0 .. d31 weight``
Node ids are implicit (line order, starting at 1; 0 is the root), leaves
get word ids in order of appearance.

Two consumption modes:

* :meth:`HierVocabulary.assign` — exact DBoW2 leaf word ids by tree
  descent: kernel K16 (:func:`dbow_descend`, `csrc/dbow_descend.cu`, over
  the tree's child-block table, :func:`child_blocks`) on the card,
  :func:`dbow_descend_plain` on the CPU, bit for bit alike (integer
  distances, one gathered float).
* :meth:`HierVocabulary.flatten` — a flat ``(K, 32)`` word-center matrix
  for the dense BoW database (`models/kf_database.py`), cut at the deepest
  tree level whose node count fits ``max_words`` (leaves above the cut
  keep the partition exact).

Parsing, flattening and writing stay numpy and exact.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import DeviceLike, check_cuda, check_tensor, is_cpu, resolve_device

# a distance no child reaches (256 at most): an empty child slot
NO_CHILD_DIST = 1 << 14
# the kernel packs (distance << 17 | slot) into one 32-bit key: 15 bits
# hold NO_CHILD_DIST, 17 the slot
MAX_BRANCHING = 1 << 17

_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)

# the code of an empty slot in a child-block table
EMPTY_SLOT = np.iinfo(np.int32).min


class ChildBlocks(NamedTuple):
    """A tree's child-block table (K16's input, :func:`child_blocks`): the
    nodes with a child ("inner") numbered in breadth-first order from the
    root, and for inner number i its k children in slot order."""

    rows: torch.Tensor        # (n_inner * k, 32) uint8: the children's rows, 0 if empty
    nxt: torch.Tensor         # (n_inner, k) int32: a child's inner number, ~node
                              # for a child without children, EMPTY_SLOT for none
    node_of: torch.Tensor     # (n_inner,) int32: the node of each inner number
    root: int                 # the root's code: 0, or ~0 = -1 without children

    def to(self, device):
        return self._replace(rows=self.rows.to(device), nxt=self.nxt.to(device),
                             node_of=self.node_of.to(device))


def child_blocks(children: np.ndarray, node_desc: np.ndarray) -> ChildBlocks:
    """The child-block table of a tree (``children`` (n_nodes, k) int32, -1
    an empty slot; ``node_desc`` (n_nodes, 32) uint8) as CPU tensors: every
    node reachable from the root that has a child gets an inner number, level
    by level (a level's nodes in the order their parents list them), so the
    upper levels, which every descent reads, lie together at the table's
    start."""
    children = np.asarray(children, np.int32)
    node_desc = np.asarray(node_desc, np.uint8)
    n_nodes, k = children.shape
    has_child = (children >= 0).any(1)
    seen = np.zeros(n_nodes, bool)
    seen[0] = True
    levels, level = [], np.zeros(1, np.int64)
    while level.size:
        inner = level[has_child[level]]
        levels.append(inner)
        ch = children[inner].ravel()
        ch = ch[ch >= 0]
        _, first = np.unique(ch, return_index=True)
        ch = ch[np.sort(first)]
        level = ch[~seen[ch]].astype(np.int64)
        seen[level] = True
    node_of = np.concatenate(levels).astype(np.int32)
    inner_of = np.full(n_nodes, -1, np.int64)
    inner_of[node_of] = np.arange(node_of.size)
    ch = children[node_of]
    filled = ch >= 0
    safe = np.where(filled, ch, 0)
    nxt = np.where(filled, np.where(inner_of[safe] >= 0, inner_of[safe], ~safe), EMPTY_SLOT)
    rows = np.where(filled[..., None], node_desc[safe], 0).reshape(-1, 32)
    return ChildBlocks(torch.from_numpy(np.ascontiguousarray(rows, np.uint8)),
                       torch.from_numpy(nxt.astype(np.int32)), torch.from_numpy(node_of),
                       0 if has_child[0] else -1)


class HierVocabulary:
    """Parsed DBoW2 vocabulary tree in flat numpy arrays."""

    def __init__(self, k, L, children, node_desc, node_weight, leaf_word_id,
                 depth, scoring=0, weighting=0):
        self.k = int(k)
        self.L = int(L)
        self.children = children          # (n_nodes, k) int32, -1 = none
        self.node_desc = node_desc        # (n_nodes, 32) uint8
        self.node_weight = node_weight    # (n_nodes,) float32
        self.leaf_word_id = leaf_word_id  # (n_nodes,) int32, -1 = inner
        self.depth = depth                # (n_nodes,) int32
        self.scoring = scoring
        self.weighting = weighting
        self.n_words = int((leaf_word_id >= 0).sum())
        self._trees = {}
        self._blocks = {}
        self.table_build_s = None

    # ------------------------------------------------------------- descent
    def tree_on(self, device: torch.device):
        """The tree's (children, node_desc, node_weight, leaf_word_id) as
        contiguous tensors on ``device``, moved there once and cached; on a
        card also its child-block table (:meth:`blocks_on`), built once."""
        key = str(device)
        tree = self._trees.get(key)
        if tree is None:
            children = np.ascontiguousarray(self.children, np.int32)
            n_nodes = len(children)
            if children.ndim != 2 or children.shape[1] != self.k or n_nodes < 1:
                raise ValueError(f"children must be (n_nodes, {self.k}), got {children.shape}")
            if children.size and (children.max() >= n_nodes or children.min() < -1):
                raise ValueError("a child id lies outside the tree")
            tree = tuple(torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
                         for a, dt in ((children, np.int32), (self.node_desc, np.uint8),
                                       (self.node_weight, np.float32),
                                       (self.leaf_word_id, np.int32)))
            self._trees[key] = tree
            if not is_cpu(tree[0]):
                t0 = time.perf_counter()
                blocks = child_blocks(children, self.node_desc).to(device)
                self._blocks[key] = blocks
                self.table_build_s = time.perf_counter() - t0
        return tree

    def blocks_on(self, device: torch.device) -> ChildBlocks:
        """The tree's child-block table on a card, built by :meth:`tree_on`
        (``table_build_s`` its build's seconds, host and upload)."""
        self.tree_on(device)
        return self._blocks[str(device)]

    def assign(self, descs_u8, mask=None, device: DeviceLike = None):
        """Exact DBoW2 word assignment by tree descent.

        descs_u8: (N, 32) uint8 (numpy or a tensor); mask: (N,) bool or
        None.  Returns ``(word_ids (N,) int32, weights (N,) float32)``
        tensors on ``device`` (default: the card; ``"cpu"`` runs the plain
        version); masked rows get word id -1, weight 0."""
        if device is None and isinstance(descs_u8, torch.Tensor):
            device = descs_u8.device
        dev = resolve_device(device)
        descs = torch.as_tensor(descs_u8, dtype=torch.uint8).to(dev).contiguous()
        m = None if mask is None else torch.as_tensor(mask, dtype=torch.bool).to(dev).contiguous()
        tree = self.tree_on(dev)
        return dbow_descend(descs, m, *tree, self.L, blocks=self._blocks.get(str(dev)))

    # ------------------------------------------------------------- flatten
    def flatten(self, max_words: int = 4096):
        """Flat word-center matrix for the dense BoW pipeline.

        Cuts the tree at the deepest level with <= ``max_words`` nodes
        (counting leaves that terminate above the cut, so the cut is a
        complete partition of descriptor space).  Returns ``(vocab
        (K, 32) uint8, idf_weights (K,) f32)``.
        """
        is_leaf = self.leaf_word_id >= 0
        best = 1
        for lvl in range(1, self.L + 1):
            n = int(((self.depth == lvl) | (is_leaf & (self.depth < lvl))).sum())
            if n <= max_words:
                best = lvl
            else:
                break
        sel = (self.depth == best) | (is_leaf & (self.depth < best))
        sel &= self.depth > 0  # never the root
        idx = np.where(sel)[0]
        return (self.node_desc[idx].copy(),
                self.node_weight[idx].astype(np.float32).copy())


def dbow_descend_plain(descs: torch.Tensor, mask: Optional[torch.Tensor],
                       children: torch.Tensor, node_desc: torch.Tensor,
                       node_weight: torch.Tensor, leaf_word_id: torch.Tensor,
                       L: int):
    """Plain version of :func:`dbow_descend` (any device): ``L`` steps of
    gather, XOR, a popcount table, ``where`` and ``torch.argmin`` (the
    first minimum, as ``jnp.argmin``)."""
    dev = descs.device
    pop = _POPCOUNT8.to(dev)
    node = torch.zeros(descs.shape[0], dtype=torch.long, device=dev)
    for _ in range(L):
        ch = children[node]                                      # (N, k)
        valid = ch >= 0
        cd = node_desc[ch.clamp(min=0).long()]                   # (N, k, 32)
        dist = pop[(cd ^ descs[:, None, :]).long()].sum(-1)      # (N, k)
        dist = torch.where(valid, dist, torch.full_like(dist, NO_CHILD_DIST))
        nxt = ch.gather(1, torch.argmin(dist, dim=1, keepdim=True))[:, 0]
        # a leaf above depth L has no children: stay put
        node = torch.where(valid.any(1), nxt.long(), node)
    words, weights = leaf_word_id[node], node_weight[node]
    if mask is not None:
        words = torch.where(mask, words, torch.full_like(words, -1))
        weights = torch.where(mask, weights, torch.zeros_like(weights))
    return words, weights


def dbow_descend(descs: torch.Tensor, mask: Optional[torch.Tensor],
                 children: torch.Tensor, node_desc: torch.Tensor,
                 node_weight: torch.Tensor, leaf_word_id: torch.Tensor, L: int,
                 blocks: Optional[ChildBlocks] = None):
    """DBoW2 tree descent (`covins_tpu/ops/dbow_import.py:54
    HierVocabulary.assign`): each (N, 32) uint8 descriptor starts at the
    root (node 0) and, ``L`` times, moves to the child of least Hamming
    distance (the lowest slot on a tie; it stays on a node with no
    child).  Returns ``(leaf_word_id[node] (N,) int32, node_weight[node]
    (N,) float32)``, ``(-1, 0.0)`` where ``mask`` (N,) bool is False.

    children: (n_nodes, k) int32, -1 an empty slot, every id < n_nodes,
    1 <= k <= MAX_BRANCHING; node_desc: (n_nodes, 32) uint8; node_weight: (n_nodes,)
    float32; leaf_word_id: (n_nodes,) int32.  CPU tensors take the plain
    version; CUDA tensors launch kernel K16 once (none for N = 0) or
    raise.  The kernel reads the tree's child-block table ``blocks``
    (:func:`child_blocks` on the card; :meth:`HierVocabulary.blocks_on`
    keeps one a device), built here from ``children`` and ``node_desc``
    when not given."""
    tensors = (descs, mask, children, node_desc, node_weight, leaf_word_id)
    if all(t is None or is_cpu(t) for t in tensors):
        return dbow_descend_plain(*tensors, L)
    name = "dbow_descend"
    dev = check_cuda(name, *tensors)
    if children.dim() != 2 or descs.dim() != 2:
        raise ValueError(f"{name}: children and descs must be 2-dimensional")
    n_nodes, k = children.shape
    N = descs.shape[0]
    if not 1 <= k <= MAX_BRANCHING or n_nodes < 1 or L < 0:
        raise ValueError(f"{name}: needs 1 <= k <= {MAX_BRANCHING} (the kernel's 17 slot "
                         f"bits), a root and L >= 0; got k={k}, {n_nodes} nodes, L={L}")
    d_ptr = check_tensor(name, "descs", descs, (N, 32), torch.uint8)
    check_tensor(name, "children", children, (n_nodes, k), torch.int32)
    check_tensor(name, "node_desc", node_desc, (n_nodes, 32), torch.uint8)
    w_ptr = check_tensor(name, "node_weight", node_weight, (n_nodes,), torch.float32)
    l_ptr = check_tensor(name, "leaf_word_id", leaf_word_id, (n_nodes,), torch.int32)
    m_ptr = None if mask is None else check_tensor(name, "mask", mask, (N,), torch.bool)
    if blocks is None:
        blocks = child_blocks(children.cpu().numpy(), node_desc.cpu().numpy()).to(dev)
    check_cuda(name, blocks.rows, blocks.nxt, blocks.node_of, descs)
    n_inner = blocks.node_of.shape[0] if blocks.node_of.dim() == 1 else -1
    r_ptr = check_tensor(name, "blocks.rows", blocks.rows, (n_inner * k, 32), torch.uint8)
    x_ptr = check_tensor(name, "blocks.nxt", blocks.nxt, (n_inner, k), torch.int32)
    o_ptr = check_tensor(name, "blocks.node_of", blocks.node_of, (n_inner,), torch.int32)
    if d_ptr % 16 or r_ptr % 16:
        raise ValueError(f"{name}: descs and the table's rows must be 16-byte aligned")
    if n_inner * k >= 1 << 31:
        raise ValueError(f"{name}: the table holds {n_inner} x {k} slots, over 2**31")
    words = torch.empty(N, dtype=torch.int32, device=dev)
    weights = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return words, weights
    lib = cuda_build.library(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_dbow_descend(d_ptr, m_ptr, N, r_ptr, x_ptr, o_ptr, n_inner, w_ptr,
                                     l_ptr, k, L, blocks.root, words.data_ptr(),
                                     weights.data_ptr(), stream)
    cuda_build.check(rc, name)
    dbow_descend.launches += 1
    return words, weights


dbow_descend.launches = 0


def load_orb_vocabulary_text(path: str) -> HierVocabulary:
    """Parse a DBoW2 text vocabulary (`ORBvoc.txt`)."""
    with open(path) as fh:
        first = fh.readline().split()
        k, L = int(first[0]), int(first[1])
        scoring = int(first[2]) if len(first) > 2 else 0
        weighting = int(first[3]) if len(first) > 3 else 0
        body = fh.read()
    toks = np.array(body.split(), dtype=np.float64)
    ncols = 2 + 32 + 1  # parent, is_leaf, 32 descriptor bytes, weight
    if toks.size % ncols:
        raise ValueError(f"{path}: malformed DBoW2 text vocabulary")
    rows = toks.reshape(-1, ncols)
    n_nodes = len(rows) + 1  # + root

    parent = np.zeros(n_nodes, np.int32)
    parent[1:] = rows[:, 0].astype(np.int32)
    is_leaf = np.zeros(n_nodes, bool)
    is_leaf[1:] = rows[:, 1] > 0
    node_desc = np.zeros((n_nodes, 32), np.uint8)
    node_desc[1:] = rows[:, 2:34].astype(np.uint8)
    node_weight = np.zeros(n_nodes, np.float32)
    node_weight[1:] = rows[:, 34].astype(np.float32)

    children = np.full((n_nodes, k), -1, np.int32)
    slot = np.zeros(n_nodes, np.int32)
    for nid in range(1, n_nodes):  # child lists keep file order, like the reference
        p = parent[nid]
        children[p, slot[p]] = nid
        slot[p] += 1

    leaf_word_id = np.full(n_nodes, -1, np.int32)
    leaf_word_id[is_leaf] = np.arange(int(is_leaf.sum()), dtype=np.int32)

    # depth by repeated parent-propagation (parents precede children in the
    # file, so L passes converge for any tree of depth L; a single
    # fancy-indexed assignment would read the OLD depths)
    depth = np.zeros(n_nodes, np.int32)
    for _ in range(L):
        depth[1:] = depth[parent[1:]] + 1
    return HierVocabulary(k, L, children, node_desc, node_weight,
                          leaf_word_id, depth, scoring, weighting)


def save_orb_vocabulary_text(voc: HierVocabulary, path: str) -> None:
    """Write the DBoW2 text format (round-trip / test support)."""
    with open(path, "w") as fh:
        fh.write(f"{voc.k} {voc.L} {voc.scoring} {voc.weighting}\n")
        # nodes in id order (the format's implicit ids are line numbers)
        n_nodes = len(voc.node_desc)
        parent = np.zeros(n_nodes, np.int32)
        for p in range(n_nodes):
            for c in voc.children[p]:
                if c >= 0:
                    parent[c] = p
        for nid in range(1, n_nodes):
            d = " ".join(str(int(x)) for x in voc.node_desc[nid])
            leaf = 1 if voc.leaf_word_id[nid] >= 0 else 0
            fh.write(f"{parent[nid]} {leaf} {d} "
                     f"{float(voc.node_weight[nid])}\n")
