"""Indexed allele list and permutation mapping between lists.

Mirrors the reference's `AlleleList`/`Permutation` semantics
(src/model/allele_list.rs:7-200): an `AlleleList` is an insertion-ordered
set of alleles; `permutation(target)` builds the index mapping used when
subsetting or reordering allele axes of likelihood matrices
(src/model/allele_likelihood_matrix_mapper.rs)."""


class AlleleList:
    """Insertion-ordered unique allele collection (allele_list.rs:7-121)."""

    __slots__ = ("_alleles", "_index")

    def __init__(self, alleles=()):
        self._alleles = []
        self._index = {}
        for a in alleles:
            if a not in self._index:
                self._index[a] = len(self._alleles)
                self._alleles.append(a)

    def number_of_alleles(self) -> int:
        return len(self._alleles)

    def __len__(self):
        return len(self._alleles)

    def index_of_allele(self, allele):
        """Index of `allele`, or None when absent (allele_list.rs:36)."""
        return self._index.get(allele)

    def get_allele(self, index: int):
        return self._alleles[index]

    def contains_allele(self, allele) -> bool:
        return allele in self._index

    def index_of_reference(self):
        """First reference allele's index, or None (allele_list.rs:93)."""
        for i, a in enumerate(self._alleles):
            if a.is_ref:
                return i
        return None

    def as_list(self) -> list:
        return list(self._alleles)

    def __eq__(self, other):
        return (isinstance(other, AlleleList)
                and self._alleles == other._alleles)

    def __iter__(self):
        return iter(self._alleles)

    def permutation(self, target: "AlleleList") -> "AllelePermutation":
        return AllelePermutation(self, target)


class AllelePermutation:
    """Mapping from an original allele list onto a target list that is a
    (possibly partial, possibly reordered) selection of it
    (allele_list.rs:149-200 Permutation::new).

    Raises ValueError when the target is not drawn from the original."""

    __slots__ = ("_from", "_to", "_from_index", "_kept", "_non_permuted",
                 "_partial")

    def __init__(self, original: AlleleList, target: AlleleList):
        self._from = original
        self._to = target
        if original == target:
            n = original.number_of_alleles()
            self._from_index = list(range(n))
            self._kept = [True] * n
            self._non_permuted = True
            self._partial = False
            return
        from_size = original.number_of_alleles()
        to_size = target.number_of_alleles()
        if from_size < to_size:
            raise ValueError(
                "target allele list is not a permutation of the original")
        kept = [False] * from_size
        from_index = []
        non_permuted = from_size == to_size
        for i in range(to_size):
            oi = original.index_of_allele(target.get_allele(i))
            if oi is None:
                raise ValueError(
                    "target allele is not in the original allele list")
            kept[oi] = True
            from_index.append(oi)
            if oi != i:
                non_permuted = False
        self._from_index = from_index
        self._kept = kept
        self._non_permuted = non_permuted
        self._partial = from_size != to_size

    def is_partial(self) -> bool:
        return self._partial

    def is_non_permuted(self) -> bool:
        return self._non_permuted

    def to_index(self, from_index: int):
        """Target index holding the original allele, or None when dropped."""
        allele = self._from.get_allele(from_index)
        return self._to.index_of_allele(allele)

    def from_index(self, to_index: int) -> int:
        return self._from_index[to_index]

    def is_kept(self, from_index: int) -> bool:
        return self._kept[from_index]

    def from_size(self) -> int:
        return self._from.number_of_alleles()

    def to_size(self) -> int:
        return self._to.number_of_alleles()

    def from_list(self) -> list:
        return self._from.as_list()

    def to_list(self) -> list:
        return self._to.as_list()

    # the permutation acts as the target allele list (AlleleListPermutation)
    def number_of_alleles(self) -> int:
        return self._to.number_of_alleles()

    def index_of_allele(self, allele):
        return self._to.index_of_allele(allele)

    def get_allele(self, index: int):
        return self._to.get_allele(index)
