"""Core variant data model: Allele, Genotype, VariantContext.

Lean re-design of the reference's variant records
(reference/src/model/byte_array_allele.rs:1-271,
src/genotype/genotype_builder.rs:1-539, src/model/variant_context.rs:30-1616)
carrying only the state the pipeline uses; numerics (GLs, QUAL) live in
numpy float64 arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NON_REF_BASES = b"<NON_REF>"
SPAN_DEL_BASES = b"*"


@dataclass(frozen=True)
class Allele:
    bases: bytes
    is_ref: bool = False

    @property
    def is_symbolic(self) -> bool:
        # byte_array_allele.rs:152-158 would_be_symbolic_allele: single-byte
        # alleles (including the spanning deletion '*') are NOT symbolic
        if len(self.bases) <= 1:
            return False
        return self.bases.startswith(b"<") or self.bases.endswith(b">")

    @property
    def is_span_del(self) -> bool:
        return self.bases == SPAN_DEL_BASES

    @property
    def is_called(self) -> bool:
        return self.bases != b"."

    def __len__(self):
        return len(self.bases)

    def __str__(self):
        return self.bases.decode()


NON_REF_ALLELE = Allele(NON_REF_BASES, False)
SPAN_DEL_ALLELE = Allele(SPAN_DEL_BASES, False)
NO_CALL = Allele(b".", False)


def make_fake_alleles():
    """The ref-vs-any placeholder pair used during activity profiling
    (byte_array_allele.rs create_fake_alleles)."""
    return [Allele(b"A", True), NON_REF_ALLELE]


@dataclass
class Genotype:
    """Per-sample genotype: log10 GLs in canonical order + calls/annotations."""
    sample: int
    ploidy: int
    log10_likelihoods: np.ndarray | None = None   # [G] float64
    alleles: list = field(default_factory=list)   # called Allele objects
    gq: int = -1
    dp: int = -1
    ad: np.ndarray | None = None
    attributes: dict = field(default_factory=dict)

    def has_likelihoods(self) -> bool:
        return self.log10_likelihoods is not None and len(self.log10_likelihoods) > 0

    def has_gq(self) -> bool:
        return self.gq >= 0

    def usable_for_af_calculation(self) -> bool:
        # genotype_builder.rs:232-239
        return (self.has_likelihoods() or self.has_gq()
                or any(a.is_called and not a.is_ref and not a.is_symbolic
                       for a in self.alleles))

    def pl(self) -> np.ndarray | None:
        """Phred-scaled normalized likelihoods (ints), canonical order."""
        if not self.has_likelihoods():
            return None
        gl = self.log10_likelihoods
        adjusted = -10.0 * gl
        adjusted = adjusted - adjusted.min()
        return np.minimum(np.rint(adjusted), 2147483647).astype(np.int64)


@dataclass
class VariantContext:
    tid: int
    start: int            # 0-based inclusive
    end: int              # 0-based inclusive
    alleles: list         # [Allele], ref first
    genotypes: list = field(default_factory=list)
    log10_p_error: float = 1.0
    attributes: dict = field(default_factory=dict)
    filters: list = field(default_factory=list)

    MAX_ALTERNATE_ALLELES = 180
    SUM_GL_THRESH_NOCALL = -0.1

    @property
    def reference(self) -> Allele:
        return next(a for a in self.alleles if a.is_ref)

    @property
    def alternate_alleles(self) -> list:
        return [a for a in self.alleles if not a.is_ref]

    @property
    def n_alleles(self) -> int:
        return len(self.alleles)

    @property
    def n_samples(self) -> int:
        return len(self.genotypes)

    @property
    def phred_scaled_qual(self) -> float:
        return -10.0 * self.log10_p_error + 0.0

    def get_dp(self) -> int:
        return sum(max(g.dp, 0) for g in self.genotypes)

    def is_snp(self) -> bool:
        return (len(self.reference) == 1
                and all(len(a) == 1 and not a.is_symbolic for a in self.alternate_alleles))

    def is_indel(self) -> bool:
        r = len(self.reference)
        return any(len(a) != r and not a.is_symbolic for a in self.alternate_alleles)

    def variant_type(self) -> str:
        """GATK variant-type lattice (determine_type / type_of_biallelic_
        variant, variant_context.rs): 'NO_VARIATION' | 'SNP' | 'MNP' |
        'INDEL' | 'SYMBOLIC' | 'MIXED'.  Per-alt type vs ref: symbolic ->
        SYMBOLIC; equal length -> SNP (len 1) or MNP; else INDEL.  One type
        across all alts -> that type, otherwise MIXED."""
        alts = self.alternate_alleles
        if not alts:
            return "NO_VARIATION"
        r = len(self.reference)

        def one(a):
            if a.is_symbolic:
                return "SYMBOLIC"
            if len(a) == r:
                return "SNP" if r == 1 else "MNP"
            return "INDEL"

        kinds = {one(a) for a in alts}
        return kinds.pop() if len(kinds) == 1 else "MIXED"
