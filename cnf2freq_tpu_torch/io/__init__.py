"""File formats of the port: the PlantImpute reader (``alpha``), the
output writers and checkpoint dump (``outputs``) and cross-validation
masking (``masking``).  The JAX package's other readers (haps, PLINK,
MERLIN, Gigi, ccoeff, VCF) are not ported yet."""

from .alpha import (load_plantimpute, read_alpha_data, read_alpha_map,
                    read_alpha_ped)
from .masking import (clear_unprotected, compare_imputed_output,
                      read_protected_individuals, read_protected_markers)
from .outputs import (deserialize, output_ped, write_genotype_table,
                      write_haplotype_dump, write_line_origin_table)

__all__ = [
    "load_plantimpute", "read_alpha_data", "read_alpha_map",
    "read_alpha_ped", "clear_unprotected", "compare_imputed_output",
    "read_protected_individuals", "read_protected_markers", "deserialize",
    "output_ped", "write_genotype_table", "write_haplotype_dump",
    "write_line_origin_table",
]
