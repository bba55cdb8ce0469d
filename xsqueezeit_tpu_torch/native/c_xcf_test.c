/*
 * c_xcf_test — value-level test of the drop-in c_xcf_* API.
 *
 * Walks one or two files (plain BCF and/or XSI variant files) with the
 * htslib-shim synced readers, fetching genotypes through
 * c_xcf_get_genotypes.  With one file it prints per-record genotype
 * checksums (compared against the Python accessor by tests/test_native.py);
 * with two files it lockstep-compares every genotype integer and fails on
 * the first difference (the reference's lockstep_loader pattern,
 * the xSqueezeIt reference's lockstep_loader/gt_lockstep_loader.hpp:113-151).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "xsqueezeit_export/include/c_api.h"
#include "vcf.h"
#include "synced_bcf_reader.h"

int main(int argc, char **argv) {
    const char *files[2] = {NULL, NULL};
    const char *region = NULL, *target = NULL, *targets_file = NULL;
    int alleles = 0;
    int nfiles = 0;
    for (int i = 1; i < argc; ++i) {
        if (strcmp(argv[i], "-r") == 0 && i + 1 < argc) region = argv[++i];
        else if (strcmp(argv[i], "-t") == 0 && i + 1 < argc) target = argv[++i];
        else if (strcmp(argv[i], "-T") == 0 && i + 1 < argc)
            targets_file = argv[++i];
        else if (strcmp(argv[i], "-a") == 0) alleles = 1;
        else if (nfiles < 2) files[nfiles++] = argv[i];
    }
    if (nfiles < 1) {
        fprintf(stderr,
                "usage: %s <file.bcf> [other.bcf] [-r region] [-t target]\n",
                argv[0]);
        return 1;
    }
    c_xcf *x = c_xcf_new();
    bcf_srs_t *sr = bcf_sr_init();
    if (region) {
        sr->require_index = 1;
        if (bcf_sr_set_regions(sr, region, 0) < 0) {
            fprintf(stderr, "bad region %s\n", region);
            return 1;
        }
    }
    if (target && bcf_sr_set_targets(sr, target, 0, 0) < 0) {
        fprintf(stderr, "bad target %s\n", target);
        return 1;
    }
    if (targets_file &&
        bcf_sr_set_targets(sr, targets_file, 1, alleles) < 0) {
        fprintf(stderr, "bad targets file %s\n", targets_file);
        return 1;
    }
    for (int i = 0; i < nfiles; ++i) {
        if (!bcf_sr_add_reader(sr, files[i])) {
            fprintf(stderr, "cannot open %s\n", files[i]);
            bcf_sr_destroy(sr);
            c_xcf_delete(x);
            return 1;
        }
    }
    c_xcf_add_readers(x, sr);

    int nsamples = c_xcf_nsamples(files[0]);
    printf("nsamples %d\n", nsamples);
    const bcf_hdr_t *hdr0 = sr->readers[0].header;
    const char *s0 = c_xcf_sample_name(x, 0, hdr0, 0);
    const char *sl = c_xcf_sample_name(x, 0, hdr0, nsamples - 1);
    printf("first_sample %s last_sample %s\n", s0 ? s0 : "?", sl ? sl : "?");

    int *gt[2] = {NULL, NULL};
    int ngt_arr[2] = {0, 0};
    int records = 0;
    long long total_entries = 0;
    int lockstep = nfiles > 1;

    while (bcf_sr_next_line(sr)) {
        bcf1_t *line0 = bcf_sr_get_line(sr, 0);
        if (!line0) {
            fprintf(stderr, "reader 0 missing record at step %d\n", records);
            return 2;
        }
        int n0 = c_xcf_get_genotypes(x, 0, sr->readers[0].header, line0,
                                     &gt[0], &ngt_arr[0]);
        if (n0 < 0) {
            fprintf(stderr, "get_genotypes failed: %d\n", n0);
            return 2;
        }
        long long sum = 0;
        for (int i = 0; i < n0; ++i) sum += (long long)gt[0][i] * (i + 1);
        printf("record %d pos %lld n %d chk %lld\n", records,
               (long long)line0->pos, n0, sum);

        if (lockstep) {
            bcf1_t *line1 = bcf_sr_get_line(sr, 1);
            if (!line1) {
                fprintf(stderr, "reader 1 missing record at step %d\n",
                        records);
                return 3;
            }
            if (line1->n_allele != line0->n_allele) {
                fprintf(stderr, "n_allele differs at record %d\n", records);
                return 3;
            }
            int n1 = c_xcf_get_genotypes(x, 1, sr->readers[1].header, line1,
                                         &gt[1], &ngt_arr[1]);
            if (n1 != n0) {
                fprintf(stderr, "ngt differs at record %d: %d vs %d\n",
                        records, n0, n1);
                return 3;
            }
            for (int i = 0; i < n0; ++i) {
                if (gt[0][i] != gt[1][i]) {
                    fprintf(stderr,
                            "gt differs at record %d entry %d: %d vs %d\n",
                            records, i, gt[0][i], gt[1][i]);
                    return 3;
                }
            }
        }
        total_entries += n0;
        records++;
    }
    printf("records %d entries %lld%s\n", records, total_entries,
           lockstep ? " lockstep-identical" : "");
    free(gt[0]);
    free(gt[1]);
    bcf_sr_destroy(sr);
    c_xcf_delete(x);
    return 0;
}
