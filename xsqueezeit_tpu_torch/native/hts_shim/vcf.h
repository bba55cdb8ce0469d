/*
 * hts_shim/vcf.h — minimal htslib-compatible surface (no htslib required).
 *
 * Third-party tools integrate xSqueezeIt through htslib types and the
 * c_xcf_* C API (the xSqueezeIt reference's include/c_api.h:48-93, README.md:371-383).
 * This environment carries no htslib, so this shim provides the subset of
 * htslib's vcf.h that those integrations touch, backed by this package's
 * own native BCF reader (see ../c_api.cpp).  Field names and macro
 * semantics follow the public htslib API contract so that consumer code
 * (e.g. the reference's c_api_test/main.c) compiles unmodified.
 */
#ifndef HTS_SHIM_VCF_H
#define HTS_SHIM_VCF_H

#include <stdint.h>
#include <stdlib.h>

typedef int64_t hts_pos_t;

/* Opaque-ish header: n[2] must be the sample count so the standard
 * bcf_hdr_nsamples() macro works; impl is private to the shim. */
typedef struct bcf_hdr_t {
    int32_t n[3];
    void *impl;
} bcf_hdr_t;

/* One VCF/BCF record.  rid / pos / n_allele are filled; everything else
 * lives behind impl. */
typedef struct bcf1_t {
    int32_t rid;
    hts_pos_t pos;    /* 0-based */
    int32_t n_allele;
    void *impl;
} bcf1_t;

#define bcf_hdr_nsamples(hdr) ((hdr)->n[2])

/* Genotype value encoding (htslib semantics):
 *   value = (allele_index + 1) << 1 | phased  */
#define bcf_int32_missing    (-2147483647 - 1)
#define bcf_int32_vector_end (-2147483647)
#define bcf_gt_phased(idx)    ((((idx) + 1) << 1) | 1)
#define bcf_gt_unphased(idx)  (((idx) + 1) << 1)
#define bcf_gt_missing        0
#define bcf_gt_is_missing(v)  (((v) >> 1) ? 0 : 1)
#define bcf_gt_is_phased(v)   ((v) & 1)
#define bcf_gt_allele(v)      (((v) >> 1) - 1)

#ifdef __cplusplus
extern "C" {
#endif

/* bcf_get_genotypes-compatible: (re)allocates *dst with malloc/realloc,
 * stores the capacity in *ndst, returns the number of int32 genotype
 * entries written (n_samples * ploidy) or a negative errcode. */
int hts_shim_get_genotypes(const bcf_hdr_t *hdr, bcf1_t *line,
                           void **dst, int *ndst);
#define bcf_get_genotypes(hdr, line, dst, ndst) \
    hts_shim_get_genotypes((hdr), (line), (void **)(dst), (ndst))

const char *hts_shim_sample_name(const bcf_hdr_t *hdr, int sample_id);

#ifdef __cplusplus
}
#endif

#endif /* HTS_SHIM_VCF_H */
