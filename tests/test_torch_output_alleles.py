"""The port's output-allele rule against a plain statement of GATK's.

GATK's ``GenotypingEngine.calculateOutputAlleleSubset`` outputs an alt
allele when it is plausible (its AF passes the emit threshold) and is not
a spurious spanning deletion: a ``*`` allele at a site that no emitted
upstream deletion covers (``isVcCoveredByDeletion``: a deletion that
starts before the site and reaches it).  The port follows it
(calling/engine.py ``calculate_genotypes``).  The JAX package suppresses
every allele of a covered site instead, which loses one strain's SNP
under another strain's deletion.

Each case emits a 10 bp deletion at 100 (covering 101-110), then genotypes
one site and holds the port's output alleles to the plain rule, given the
plausibility that the port's own AF calculation reports.
"""
import numpy as np
import pytest

from lorikeet_tpu_torch.calling.engine import CallerConfig, GenotypingEngine
from lorikeet_tpu_torch.models.variants import (Allele, Genotype,
                                                SPAN_DEL_ALLELE,
                                                VariantContext)

A, T = Allele(b"A", True), Allele(b"T", False)
#: the emitted deletion: 0-based start and the last base it covers
DELETION = (100, 110)


def _vc(start, alleles, gls, ads):
    genotypes = [Genotype(i, 2, np.asarray(gl, float), dp=20,
                          ad=np.asarray(ad))
                 for i, (gl, ad) in enumerate(zip(gls, ads))]
    return VariantContext(0, start, start + len(alleles[0]) - 1, alleles,
                          genotypes)


def _engine_after_deletion():
    engine = GenotypingEngine(CallerConfig())
    start, last = DELETION
    deletion = _vc(start, [Allele(b"A" * (last - start + 1), True),
                           Allele(b"A", False)],
                   [[-20.0, -6.0, 0.0]], [[0, 10]])
    assert engine.calculate_genotypes(deletion) is not None
    return engine


def plain_output_alts(vc, plausible: dict, deletions: list) -> list:
    """GATK's rule: the plausible alts, less a ``*`` where no emitted
    deletion (start, last base) starts before the site and reaches it."""
    covered = any(s < vc.start <= e for s, e in deletions)
    return [a for a in vc.alternate_alleles
            if plausible[a] and not (a.is_span_del and not covered)]


#: name: (site start, alleles, GLs, ADs)
SITES = {
    # a confident SNP inside the deletion: GATK outputs it
    "snp_covered": (105, [A, T], [[-20.0, -6.0, 0.0]], [[0, 10]]),
    # a SNP and '*' inside it: both output where plausible
    "span_del_covered": (105, [A, T, SPAN_DEL_ALLELE],
                         [[-30.0, -20.0, -20.0, -20.0, 0.0, -20.0]],
                         [[0, 10, 10]]),
    # the same past the deletion: '*' is spurious there
    "span_del_past": (120, [A, T, SPAN_DEL_ALLELE],
                      [[-30.0, -20.0, -20.0, -20.0, 0.0, -20.0]],
                      [[0, 10, 10]]),
    # at the deletion's own start the site is not covered
    "span_del_same_start": (100, [A, T, SPAN_DEL_ALLELE],
                            [[-30.0, -20.0, -20.0, -20.0, 0.0, -20.0]],
                            [[0, 10, 10]]),
}


@pytest.mark.parametrize("name", sorted(SITES))
def test_output_alleles_follow_gatk(name):
    start, alleles, gls, ads = SITES[name]
    engine = _engine_after_deletion()
    vc = _vc(start, alleles, gls, ads)
    af = engine.af_calc.calculate(vc, engine.cfg.ploidy)
    plausible = {a: af.passes_threshold(a, engine.cfg.stand_min_conf)
                 for a in vc.alternate_alleles}
    assert plausible[T]
    want = plain_output_alts(vc, plausible, [DELETION])
    call = engine.calculate_genotypes(vc)
    got = [] if call is None else call.alleles[1:]
    assert got == want
    if name == "span_del_covered":
        assert SPAN_DEL_ALLELE in want


def test_the_jax_package_drops_the_covered_snp():
    from lorikeet_tpu.calling.engine import CallerConfig as JaxConfig
    from lorikeet_tpu.calling.engine import GenotypingEngine as JaxEngine
    from lorikeet_tpu.models.variants import Allele as JaxAllele
    from lorikeet_tpu.models.variants import Genotype as JaxGenotype
    from lorikeet_tpu.models.variants import VariantContext as JaxContext
    engine = JaxEngine(JaxConfig())
    start, last = DELETION
    deletion = JaxContext(0, start, last, [
        JaxAllele(b"A" * (last - start + 1), True), JaxAllele(b"A", False)],
        [JaxGenotype(0, 2, np.array([-20.0, -6.0, 0.0]), dp=20,
                     ad=np.array([0, 10]))])
    assert engine.calculate_genotypes(deletion) is not None
    snp = JaxContext(0, 105, 105, [JaxAllele(b"A", True),
                                   JaxAllele(b"T", False)],
                     [JaxGenotype(0, 2, np.array([-20.0, -6.0, 0.0]), dp=20,
                                  ad=np.array([0, 10]))])
    assert engine.calculate_genotypes(snp) is None
    port = _engine_after_deletion()
    assert port.calculate_genotypes(_vc(105, [A, T], [[-20.0, -6.0, 0.0]],
                                        [[0, 10]])).alleles[1:] == [T]
