"""File formats of the port, copies of the JAX package's numpy readers and
writers building the port's ``Pedigree``: PlantImpute (``alpha``), ccoeff,
ShapeIT haps, PLINK fam/bed, MERLIN, Gigi and the VCF rewrite, the output
writers and checkpoint dump (``outputs``) and cross-validation masking
(``masking``)."""

from .alpha import (load_plantimpute, read_alpha_data, read_alpha_map,
                    read_alpha_ped)
from .ccoeff import load_ccoeff, read_marker_data, read_marker_info, read_ped
from .masking import (clear_unprotected, compare_imputed_output,
                      read_protected_individuals, read_protected_markers)
from .haps import (create_hap_file, read_haps_full, read_haps_only,
                   read_sample)
from .gigi import load_gigi, read_gigi_map, read_gigi_ped
from .merlin import read_merlin_map, read_merlin_ped, write_merlin_ped
from .plink import read_fam_bed, write_fam_bed
from .vcf import output_vcf
from .outputs import (deserialize, output_ped, write_genotype_table,
                      write_haplotype_dump, write_line_origin_table)

__all__ = [
    "load_plantimpute", "read_alpha_data", "read_alpha_map",
    "read_alpha_ped", "load_ccoeff", "read_marker_data", "read_marker_info",
    "read_ped", "clear_unprotected", "compare_imputed_output",
    "read_protected_individuals", "read_protected_markers",
    "load_gigi", "read_gigi_map", "read_gigi_ped",
    "read_merlin_map", "read_merlin_ped", "write_merlin_ped", "deserialize",
    "output_ped", "write_genotype_table", "write_haplotype_dump",
    "write_line_origin_table", "create_hap_file", "read_haps_full",
    "read_haps_only", "read_sample", "read_fam_bed", "write_fam_bed",
    "output_vcf",
]
