"""Assembly configuration.

One frozen dataclass drives the whole pipeline (SURVEY.md §5 "Config /
flag system"): settable from the CLI and from Python, hashed into every
stage-artifact manifest for reproducibility.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Parameters of the SAGE2-style assembly pipeline.

    The defaults target ~100 bp Illumina reads at ~50x coverage (the
    reference's E. coli headline config, BASELINE.json configs[0]).
    """

    # --- k-mer layer (SURVEY.md §2 "k-mer counter" / "Error corrector") ---
    k: int = 25                     # k-mer length; 1 < k <= 31 (fits 2 uint32 words)
    solid_threshold: int = 2        # count >= threshold => k-mer is "solid"
    correction_rounds: int = 2      # spectrum-correction iterations (RACER-style)
    correction_rule: str = "single_window"  # "single_window" (pinned
                                    # round-1/2 rule) | "vote_all_windows"
                                    # (RACER-style covering-window voting;
                                    # SURVEY.md §10 parity alternative)

    # --- overlap layer (SURVEY.md §2 "Overlap detector") ---
    min_overlap: int = 40           # minimum exact suffix-prefix overlap length
    seed_len: int = 32              # seed bases for the sorted join (capped at min_overlap)

    # --- graph layer (SURVEY.md §2 "Graph builder"/"cleaner") ---
    tip_max_reads: int = 4          # dead-end unitigs of <= this many reads are tips
    bubble_max_reads: int = 10      # parallel paths of <= this many reads may be popped
    bubble_ratio: float = 0.5       # pop the branch if its coverage < ratio * rival's

    # --- traversal (SURVEY.md §2 "Copy-count / cost model", §3.5) ---
    traversal: str = "mincost"      # "unitig" (conservative) | "mincost" (SAGE-style)
    branch_dominance: float = 4.0   # prune junction branches this much weaker
    min_contig_len: int = 200       # drop contigs shorter than this many bases
    path_penalty: int = 150         # bases of uncovered copy-length a new
                                    # contig must explain (min-cost flow's
                                    # per-path opening cost)
    flow_max_extra: int = 2         # flow units allowed beyond a unitig's
                                    # expected copy count
    flow_max_component: int = 2000  # condensed-graph components larger than
                                    # this fall back to the greedy walk

    # --- scaffolding (paired-end; BASELINE.json config #1 "paired") ---
    scaffold: bool = True           # use mate pairs to scaffold contigs
                                    # when pairing info is present
    min_mate_links: int = 3         # supporting pairs to accept a join
    insert_size: Optional[int] = None  # outer insert; None => estimate
                                    # from same-contig proper pairs

    # --- capacities (static shapes; SURVEY.md §7 "Hard parts") ---
    candidate_capacity: int = 1 << 20   # max overlap candidates per batch
    reduce_capacity: int = 1 << 20      # max length-2 path expansions per pass
    reduce_backend: str = "auto"    # single-device reduction backend:
                                    # "auto" (native C++ when the edge
                                    # list is host-resident and large,
                                    # else device kernels) | "device" |
                                    # "native" (csrc/reduce_host.cpp)

    # --- parallelism (SURVEY.md §2 parallelism table) ---
    mesh_shape: Optional[Tuple[int, ...]] = None   # None => single device

    # --- streaming (SURVEY.md §7 "Datasets larger than HBM") ---
    max_device_reads: Optional[int] = None  # cap on reads resident on the
                                    # device at once; None => whole input
                                    # in-core. When the input exceeds it,
                                    # count/correct/dedup/overlap stream
                                    # in chunks of this many reads
                                    # (bit-identical to in-core).
    entry_block_reads: Optional[int] = None  # streamed overlap: stream
                                    # the ENTRY side too in blocks of
                                    # this many reads (block-nested
                                    # join). None => auto: engages when
                                    # the global seed-row count exceeds
                                    # the single-device HBM ceiling
                                    # class (stream._BLOCK_ENGAGE_ROWS).
                                    # Bit-identical to the single-slab
                                    # path. Placement-only: NOT part of
                                    # the digest.
    spill_dir: Optional[str] = None  # host-side spill directory: the
                                    # streamed pipeline's big host arrays
                                    # (corrected reads, dedup'd read
                                    # store, edge list) become memmaps
                                    # there, bounding host RSS by
                                    # O(chunk + reduced graph) instead of
                                    # O(N*L + E). Placement-only: results
                                    # are bit-identical, so it is NOT
                                    # part of the config digest.

    def __post_init__(self) -> None:
        if not (1 < self.k <= 31):
            raise ValueError(f"k must be in (1, 31], got {self.k}")
        if self.min_overlap <= self.k:
            raise ValueError(
                f"min_overlap ({self.min_overlap}) must exceed k ({self.k})"
            )
        if self.traversal not in ("unitig", "mincost"):
            raise ValueError(f"unknown traversal mode {self.traversal!r}")
        if self.correction_rule not in ("single_window", "vote_all_windows"):
            raise ValueError(
                f"unknown correction rule {self.correction_rule!r}"
            )
        if self.reduce_backend not in ("auto", "device", "native"):
            raise ValueError(
                f"unknown reduce backend {self.reduce_backend!r}"
            )

    @property
    def effective_seed_len(self) -> int:
        """Seed length actually used by the overlap join (<= 32 bases)."""
        return min(self.seed_len, self.min_overlap, 32)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["mesh_shape"] is not None:
            d["mesh_shape"] = list(d["mesh_shape"])
        # spill_dir is a placement knob (memmap vs RAM staging) with
        # bit-identical results — keep it out of the digest so spilled
        # and in-RAM runs of the same assembly share manifests; the
        # entry-block size is likewise placement-only (bit-identical,
        # tested)
        d.pop("spill_dir", None)
        d.pop("entry_block_reads", None)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AssemblyConfig":
        d = dict(d)
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def digest(self) -> str:
        """Stable hash of the config, recorded in artifact manifests."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
