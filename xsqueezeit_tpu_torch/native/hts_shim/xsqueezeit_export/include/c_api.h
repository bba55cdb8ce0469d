/*
 * c_api.h — drop-in xSqueezeIt C API (signature-compatible rebuild).
 *
 * The reference exports this exact surface for third-party integrations
 * (the xSqueezeIt reference's include/c_api.h:48-93; used by SHAPEIT4-style tools,
 * README.md:371-383): an opaque helper that routes genotype queries of a
 * synced-reader set to either htslib (plain VCF/BCF) or the XSI accessor
 * (readers whose header carries ##XSI=).  This header re-declares that
 * contract over this package's native accessor; consumer sources compile
 * unmodified (see ../../c_api_test for the reference's own test program
 * built against it).
 */
#ifndef __C_API_H__
#define __C_API_H__

#include "vcf.h"
#include "synced_bcf_reader.h"

typedef void *c_xcf;

#ifdef __cplusplus
extern "C" {
#endif

/* Allocate the mixed XSI + VCF/BCF helper. */
c_xcf *c_xcf_new();

/* Register every reader of the synced set (detects ##XSI= routing). */
void c_xcf_add_readers(c_xcf *x, bcf_srs_t *readers);

/* Re-scan the readers (after the set changed). */
void c_xcf_update_readers(c_xcf *x, bcf_srs_t *readers);

/* Sample name by index, routed to the XSI sample list when applicable. */
const char *c_xcf_sample_name(c_xcf *x, int reader_id, const bcf_hdr_t *hdr,
                              int sample_id);

/* Number of samples in a file (XSI variant files keep the sample list in
 * the .xsi container, not the BCF header, hence a dedicated entry). */
int c_xcf_nsamples(const char *fname);

/* bcf_get_genotypes equivalent with XSI support: checks whether reader_id
 * is VCF/BCF or XSI and dispatches accordingly. */
#define c_xcf_get_genotypes(x, reader_id, hdr, line, dst, ndst) \
    __c__xcf__get__genotypes__void(x, reader_id, hdr, line, (void **)(dst), ndst)
int __c__xcf__get__genotypes__void(c_xcf *x, int reader_id,
                                   const bcf_hdr_t *hdr, bcf1_t *line,
                                   void **dst, int *ndst);

/* Deallocate the helper. */
void c_xcf_delete(c_xcf *x);

#ifdef __cplusplus
}
#endif

#endif /* __C_API_H__ */
