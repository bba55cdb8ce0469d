/*
 * hts_shim/synced_bcf_reader.h — htslib synced-reader subset (no htslib).
 *
 * Implements the bcf_sr_* surface that c_xcf_* consumers use
 * (the xSqueezeIt reference's c_api_test/main.c, lockstep_loader): N readers over
 * position-sorted VCF/BCF files advanced in lockstep; bcf_sr_next_line
 * moves to the next (rid, pos) present in ANY reader and returns how many
 * readers carry it; bcf_sr_get_line yields reader i's record or NULL.
 */
#ifndef HTS_SHIM_SYNCED_BCF_READER_H
#define HTS_SHIM_SYNCED_BCF_READER_H

#include "vcf.h"

typedef struct bcf_sr_t {
    bcf_hdr_t *header;
    void *impl;
} bcf_sr_t;

/* Collapse policies (subset; the reference only uses COLLAPSE_NONE). */
#define COLLAPSE_NONE 0

typedef struct bcf_srs_t {
    int nreaders;
    bcf_sr_t *readers;
    int collapse;       /* reference sets this directly (xcf.cpp:117) */
    int require_index;  /* reference sets this directly (xcf.cpp:118) */
    void *impl;
} bcf_srs_t;

#ifdef __cplusplus
extern "C" {
#endif

bcf_srs_t *bcf_sr_init(void);
/* Returns 1 on success, 0 on failure (htslib convention). */
int bcf_sr_add_reader(bcf_srs_t *sr, const char *fname);
/* Restrict iteration to regions ("chr", "chr:from-to", comma-separated;
 * is_file: one region or tab-separated chrom/from/to per line, 1-based
 * inclusive).  Must be called BEFORE adding readers (htslib contract);
 * readers then require a `.csi` index and seek to each region
 * (reference: initialize_bcf_file_reader_with_region, xcf.cpp:115-127).
 * Records overlap regions by their [POS, POS+rlen) span.
 * Returns 0 on success, -1 on failure. */
int bcf_sr_set_regions(bcf_srs_t *sr, const char *regions, int is_file);
/* Streaming position filter (no index needed): keep records whose POS
 * lies inside a target (htslib targets semantics: start position only).
 * `alleles` subsetting is not supported and must be 0.
 * Returns 0 on success, -1 on failure. */
int bcf_sr_set_targets(bcf_srs_t *sr, const char *targets, int is_file,
                       int alleles);
/* Advance to the next position; returns the number of readers set. */
int bcf_sr_next_line(bcf_srs_t *sr);
bcf1_t *hts_shim_sr_get_line(bcf_srs_t *sr, int i);
#define bcf_sr_get_line(sr_, i_) hts_shim_sr_get_line((sr_), (i_))
/* Nonzero if reader i has a record at the current position. */
int bcf_sr_has_line(bcf_srs_t *sr, int i);
void bcf_sr_destroy(bcf_srs_t *sr);
/* The path reader i was opened with. */
const char *hts_shim_reader_fname(bcf_srs_t *sr, int i);

#ifdef __cplusplus
}
#endif

#endif /* HTS_SHIM_SYNCED_BCF_READER_H */
