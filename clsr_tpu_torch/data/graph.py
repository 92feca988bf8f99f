"""The user-item / item-item interaction graph of the LGN model.

Counterpart of clsr_tpu/data/graph.py (the reference's adjacency
builders, lgn.py:163-506): from the train TSV, each user's LAST
expanding-history line (their whole history and its target); user-item
edges to every history item, both ways; item-item edges between
consecutive items of history + target, both ways (lgn.py:172-228); the
joint graph [[0, R_ui], [R_ui^T, R_ii]] plus the identity, row-normalized
as D^-1 (A + I) (`normalized_adj_single`); and the item -> cate map,
the last assignment winning (target, then history, user after user, as
JAX's loop writes it; lgn.py:231-287).

The edge set and the weights 1/deg are JAX's, bit for bit (duplicates
kept as JAX keeps them: a self loop of two equal consecutive items
beside the identity's); the builder is vectorised in numpy (JAX's
Python sets take minutes at Taobao's node count), and the edges come
sorted by (src, dst), each source's edges one run, as the graph
convolution reads them (ops/graph_conv.py `GraphEdges`, which sorts them
by dst once on the device for the backward).  Node ids:
users 0..U-1, items U..U+I-1.  The packed format's builder
(data/packed.py `build_interaction_graph_packed`) calls
`build_graph_from_arrays` on each user's last train line.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from clsr_tpu_torch.data.vocab import Vocab


@dataclasses.dataclass(eq=False)
class InteractionGraph:
    """COO normalized adjacency over users + items, and item2cate."""

    n_users: int
    n_items: int
    src: np.ndarray        # [E] int32, ascending (then dst ascending)
    dst: np.ndarray        # [E] int32
    weight: np.ndarray     # [E] float32, 1 / deg(src)
    item2cate: np.ndarray  # [I] int32

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items


def _unique_pairs(a: np.ndarray, b: np.ndarray, n_b: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct (a, b) pairs, ascending, as a sorted key a * n_b + b
    with its repeats dropped (np.unique hashes int64 keys in numpy 2.3,
    minutes at 10^7-10^8 keys; a sort takes seconds)."""
    key = np.sort(a.astype(np.int64) * n_b + b)
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    return key // n_b, key % n_b


def build_graph_from_arrays(users: np.ndarray, offsets: np.ndarray,
                            items: np.ndarray, cates: np.ndarray,
                            n_users: int, n_items: int) -> InteractionGraph:
    """The graph of full-history sequences given flat, in order: sequence
    s is user users[s]'s items[offsets[s]:offsets[s + 1]] (its last the
    target) and their cates."""
    users = np.asarray(users, np.int64)
    offsets = np.asarray(offsets, np.int64)
    it = np.asarray(items, np.int64)
    ct = np.asarray(cates, np.int64)
    lens = offsets[1:] - offsets[:-1]
    seq = np.repeat(np.arange(len(users)), lens)
    seq_user = users[seq]
    is_target = np.zeros(len(it), bool)
    is_target[offsets[1:][lens > 0] - 1] = True

    # item2cate: within a sequence the target is written first, then the
    # history; the last write of an item wins.  Write order as a key:
    # a sequence's target offsets[s], its history position p + 1; the
    # sorted (item, write) keys end each item's run with its last write
    pos = np.arange(len(it))
    write = np.where(is_target, offsets[:-1][seq], pos + 1)
    at_write = np.empty(len(it) + 1, np.int64)
    at_write[write] = pos
    stride = len(it) + 1
    key = np.sort(it * stride + write)
    last = np.ones(len(key), bool)
    last[:-1] = key[1:] // stride != key[:-1] // stride
    key = key[last]
    item2cate = np.zeros(n_items, dtype=np.int32)
    item2cate[key // stride] = ct[at_write[key % stride]]

    hist = ~is_target
    ui_u, ui_i = _unique_pairs(seq_user[hist], it[hist], n_items)
    nxt = np.ones(len(it), bool)
    nxt[-1:] = False
    nxt &= ~is_target                     # (item t, item t + 1) pairs
    a, b = it[nxt], it[1:][nxt[:-1]]
    ii_i, ii_j = _unique_pairs(np.concatenate([a, b]),
                               np.concatenate([b, a]), n_items)

    n = n_users + n_items
    # the joint graph's edges as keys src * n + dst, sorted
    key = np.concatenate([ui_u * n + n_users + ui_i,
                          (n_users + ui_i) * n + ui_u,
                          (n_users + ii_i) * n + n_users + ii_j,
                          np.arange(n, dtype=np.int64) * (n + 1)])
    key.sort()
    rows = (key // n).astype(np.int32)
    cols = (key % n).astype(np.int32)
    del key
    degree = np.bincount(rows, minlength=n).astype(np.float32)
    d_inv = np.where(degree > 0, 1.0 / np.maximum(degree, 1), 0.0)
    weight = d_inv[rows].astype(np.float32)
    return InteractionGraph(n_users=n_users, n_items=n_items, src=rows,
                            dst=cols, weight=weight, item2cate=item2cate)


def build_graph_from_sequences(seqs: Iterable[Tuple[int, Sequence[int],
                                                    Sequence[int]]],
                               n_users: int, n_items: int
                               ) -> InteractionGraph:
    """The graph of (uid, item_ids, cate_ids) full-history sequences, the
    last element of each the target (JAX's builder's input)."""
    users, lens, items, cates = [], [], [], []
    for uid, item_ids, cate_ids in seqs:
        users.append(uid)
        lens.append(len(item_ids))
        items.extend(item_ids)
        # history cates by position, the target's cate last (JAX's zip
        # and cate_ids[-1])
        cates.extend(list(cate_ids[:len(item_ids) - 1]) + [cate_ids[-1]])
    offsets = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
    return build_graph_from_arrays(np.asarray(users, np.int64), offsets,
                                   np.asarray(items, np.int64),
                                   np.asarray(cates, np.int64), n_users,
                                   n_items)


def build_interaction_graph(train_file: str, user_vocab: Vocab,
                            item_vocab: Vocab, cate_vocab: Vocab
                            ) -> InteractionGraph:
    """The graph of a train TSV (label, user, item, cate, time, item
    history, cate history, ...): each user's last line, users in the
    order of their first line (a dict's, as JAX's)."""
    last_per_user: Dict[int, Tuple] = {}
    with open(train_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cols = line.split("\t")
            uid = user_vocab.lookup(cols[1])
            last_per_user[uid] = (cols[2], cols[3],
                                  cols[5].split(","), cols[6].split(","))

    def seqs():
        for uid, (ti, tc, hi, hc) in last_per_user.items():
            yield (uid, item_vocab.lookup_many(hi) + [item_vocab.lookup(ti)],
                   cate_vocab.lookup_many(hc) + [cate_vocab.lookup(tc)])

    return build_graph_from_sequences(seqs(), len(user_vocab),
                                      len(item_vocab))
