/* svtrek_native — C fast paths for the svtrek_tpu framework.
 *
 * Provides (1) an indexed BAM region reader (BGZF + BAI + record parse)
 * that fills packed arrays ready for the device packer, replacing the
 * role htslib plays for the reference (SURVEY.md 2.13), and (2) a scalar
 * refinement baseline with the reference's exact semantics
 * (refinement.c:41-325) used as the CPU performance baseline in bench.py.
 *
 * Fresh implementation from the SAM/BAM/BAI format specs; exposed to
 * Python via ctypes (no pybind11 in this environment).
 *
 * Build: python -m svtrek_tpu_torch.native.build
 */
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <time.h>
#include <zlib.h>
#ifdef SVTREK_HAVE_LIBDEFLATE
#include <libdeflate.h>  /* ~2.7x faster raw-deflate decode than zlib */
#endif

/* ------------------------------------------------------------------ */
/* dynamic buffers                                                      */

typedef struct {
    void *data;
    size_t len;    /* elements used */
    size_t cap;    /* elements allocated */
    size_t esz;    /* element size */
} vec_t;

static void vec_init(vec_t *v, size_t esz) {
    v->data = NULL; v->len = 0; v->cap = 0; v->esz = esz;
}
static void vec_free(vec_t *v) { free(v->data); vec_init(v, v->esz); }
static void *vec_push(vec_t *v, size_t n) {
    if (v->len + n > v->cap) {
        size_t nc = v->cap ? v->cap : 1024;
        while (nc < v->len + n) nc *= 2;
        v->data = realloc(v->data, nc * v->esz);
        if (!v->data) { fprintf(stderr, "svtrek_native: OOM\n"); abort(); }
        v->cap = nc;
    }
    void *p = (char *)v->data + v->len * v->esz;
    v->len += n;
    return p;
}

/* ------------------------------------------------------------------ */
/* BGZF                                                                 */

/* Decompressed-block cache: region fetches constantly revisit the same
 * blocks (a DEL's end window usually lies inside its start window, and
 * long reads span many windows), so caching the inflate output — by far
 * the dominant fetch cost — turns those into memcpys.  Fully
 * associative, LRU by stamp; 64 slots x 64 KiB = 4 MiB per handle
 * (handles are per producer thread, shared-nothing). */
#define BGZF_CACHE_SLOTS 64

typedef struct {
    int64_t coffset;       /* compressed offset; -1 = empty slot */
    int64_t next_coffset;
    int ulen;
    int eof;
    uint32_t stamp;
    uint8_t ubuf[65536];
} bgzf_blk_t;

typedef struct {
    FILE *fp;
    bgzf_blk_t *slots;     /* decompressed-block LRU cache */
    uint32_t tick;
    int64_t coffset;       /* cursor: compressed offset of current block */
    int upos;              /* cursor within the current block */
    int64_t inflate_ns;    /* counters since the last svbam_counters: */
    int64_t inflate_bytes; /* time in bgzf_inflate_block, bytes it made */
#ifdef SVTREK_HAVE_LIBDEFLATE
    struct libdeflate_decompressor *dec;  /* reused across blocks */
#endif
} bgzf_t;

static int bgzf_init(bgzf_t *z) {
    z->slots = malloc(sizeof(bgzf_blk_t) * BGZF_CACHE_SLOTS);
    if (!z->slots) return -1;
    for (int i = 0; i < BGZF_CACHE_SLOTS; i++) z->slots[i].coffset = -1;
    z->tick = 0;
    z->coffset = 0;
    z->upos = 0;
    z->inflate_ns = z->inflate_bytes = 0;
#ifdef SVTREK_HAVE_LIBDEFLATE
    z->dec = libdeflate_alloc_decompressor();
    if (!z->dec) { free(z->slots); z->slots = NULL; return -1; }
#endif
    return 0;
}

static void bgzf_destroy(bgzf_t *z) {
    free(z->slots);
    z->slots = NULL;
#ifdef SVTREK_HAVE_LIBDEFLATE
    if (z->dec) { libdeflate_free_decompressor(z->dec); z->dec = NULL; }
#endif
}

/* Raw-deflate one block payload into out (cap 64 KiB); returns the
 * produced length, or -1 on corruption.  The ISIZE trailer is checked
 * by the caller against the produced length (cheap integrity check;
 * a bit-flipped stream that still parses yields the wrong length). */
static int bgzf_inflate_block(bgzf_t *z, const uint8_t *cbuf, int csize,
                              uint8_t *out, int outcap) {
#ifdef SVTREK_HAVE_LIBDEFLATE
    size_t actual = 0;
    enum libdeflate_result r = libdeflate_deflate_decompress(
        z->dec, cbuf, (size_t)csize, out, (size_t)outcap, &actual);
    if (r != LIBDEFLATE_SUCCESS) return -1;
    return (int)actual;
#else
    z_stream s;
    memset(&s, 0, sizeof(s));
    s.next_in = (uint8_t *)cbuf; s.avail_in = csize;
    s.next_out = out; s.avail_out = outcap;
    if (inflateInit2(&s, -15) != Z_OK) return -1;
    int r = inflate(&s, Z_FINISH);
    inflateEnd(&s);
    if (r != Z_STREAM_END) return -1;
    return (int)s.total_out;
#endif
}

static bgzf_blk_t *bgzf_find(bgzf_t *z, int64_t coffset) {
    for (int i = 0; i < BGZF_CACHE_SLOTS; i++)
        if (z->slots[i].coffset == coffset) {
            z->slots[i].stamp = ++z->tick;
            return &z->slots[i];
        }
    return NULL;
}

/* Parse the block header at coffset; *bsize = compressed block size.
 * Returns 0, 1 on clean EOF (no header bytes), -1 on corruption.
 * Leaves the file positioned after the extra field. */
static int bgzf_header(bgzf_t *z, int64_t coffset, int64_t *bsize,
                       int *xlen_out) {
    uint8_t hdr[12];
    if (fseeko(z->fp, coffset, SEEK_SET) != 0) return -1;
    size_t got = fread(hdr, 1, 12, z->fp);
    if (got == 0) return 1; /* EOF */
    if (got < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b) return -1;
    int xlen = hdr[10] | (hdr[11] << 8);
    uint8_t extra[4096];
    if (xlen > (int)sizeof(extra)) return -1;
    if (fread(extra, 1, xlen, z->fp) != (size_t)xlen) return -1;
    int64_t bs = -1;
    for (int i = 0; i + 4 <= xlen;) {
        int si1 = extra[i], si2 = extra[i + 1];
        int slen = extra[i + 2] | (extra[i + 3] << 8);
        if (si1 == 'B' && si2 == 'C' && slen == 2)
            bs = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        i += 4 + slen;
    }
    if (bs < 0) return -1;
    *bsize = bs;
    if (xlen_out) *xlen_out = xlen;
    return 0;
}

/* Block sizes without inflating: *bsize compressed, *isize uncompressed
 * (the gzip ISIZE trailer).  0 ok, 1 clean EOF, -1 corruption. */
static int bgzf_peek(bgzf_t *z, int64_t coffset, int64_t *bsize,
                     int64_t *isize) {
    int r = bgzf_header(z, coffset, bsize, NULL);
    if (r != 0) return r;
    uint8_t tail[4];
    if (fseeko(z->fp, coffset + *bsize - 4, SEEK_SET) != 0) return -1;
    if (fread(tail, 1, 4, z->fp) != 4) return -1;
    *isize = (int64_t)tail[0] | ((int64_t)tail[1] << 8) |
             ((int64_t)tail[2] << 16) | ((int64_t)tail[3] << 24);
    return 0;
}

/* Load (inflate) the block at coffset into the cache; cache hits skip
 * the seek+read+inflate entirely (overlapping windows re-read the same
 * blocks constantly -- e.g. a DEL's end window usually lies inside its
 * start window).  Returns the slot, or NULL on corruption; a clean EOF
 * yields a slot with eof=1, ulen=0. */
static bgzf_blk_t *bgzf_ensure(bgzf_t *z, int64_t coffset) {
    bgzf_blk_t *hit = bgzf_find(z, coffset);
    if (hit) return hit;
    bgzf_blk_t *blk = NULL;   /* prefer an empty slot, else evict LRU */
    for (int i = 0; i < BGZF_CACHE_SLOTS; i++) {
        bgzf_blk_t *s = &z->slots[i];
        if (s->coffset == -1) { blk = s; break; }
        if (!blk || s->stamp < blk->stamp) blk = s;
    }
    blk->coffset = -1;        /* invalid until fully loaded */

    int64_t bsize;
    int xlen = 0;
    int hr = bgzf_header(z, coffset, &bsize, &xlen);
    if (hr == 1) { /* clean EOF */
        blk->ulen = 0; blk->eof = 1; blk->coffset = coffset;
        blk->next_coffset = coffset; blk->stamp = ++z->tick;
        return blk;
    }
    if (hr != 0) return NULL;
    int csize = (int)(bsize - 12 - xlen - 8);
    if (csize < 0) return NULL;
    uint8_t *cbuf = malloc(csize);
    if (fread(cbuf, 1, csize, z->fp) != (size_t)csize) { free(cbuf); return NULL; }
    uint8_t tail[8];
    if (fread(tail, 1, 8, z->fp) != 8) { free(cbuf); return NULL; }

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    int produced = bgzf_inflate_block(z, cbuf, csize, blk->ubuf,
                                      (int)sizeof(blk->ubuf));
    clock_gettime(CLOCK_MONOTONIC, &t1);
    free(cbuf);
    if (produced < 0) return NULL;
    z->inflate_ns += (int64_t)(t1.tv_sec - t0.tv_sec) * 1000000000 +
                     (t1.tv_nsec - t0.tv_nsec);
    z->inflate_bytes += produced;
    uint32_t isize = (uint32_t)tail[4] | ((uint32_t)tail[5] << 8) |
                     ((uint32_t)tail[6] << 16) | ((uint32_t)tail[7] << 24);
    if ((uint32_t)produced != isize) return NULL;  /* corrupt stream */
    blk->ulen = produced;
    blk->eof = 0;
    blk->coffset = coffset;
    blk->next_coffset = coffset + bsize;
    blk->stamp = ++z->tick;
    return blk;
}

/* The cursor is lazy: seek just records the position; nothing is
 * inflated until a read needs bytes. */
static int bgzf_seek(bgzf_t *z, int64_t voffset) {
    z->coffset = voffset >> 16;
    z->upos = (int)(voffset & 0xffff);
    return 0;
}

static int64_t bgzf_tell(bgzf_t *z) {
    return (z->coffset << 16) | (int64_t)z->upos;
}

static int bgzf_read(bgzf_t *z, void *out, int n) {
    uint8_t *dst = out;
    int done = 0;
    while (done < n) {
        bgzf_blk_t *b = bgzf_ensure(z, z->coffset);
        if (!b || b->eof) return done;
        int avail = b->ulen - z->upos;
        if (avail <= 0) {
            if (b->next_coffset == z->coffset) return done; /* stuck */
            z->coffset = b->next_coffset;
            z->upos = 0;
            continue;
        }
        int take = n - done < avail ? n - done : avail;
        memcpy(dst + done, b->ubuf + z->upos, take);
        z->upos += take;
        done += take;
    }
    return done;
}

/* Advance the cursor n uncompressed bytes WITHOUT inflating anything:
 * whole skipped blocks only have their header + ISIZE trailer read.
 * This is what makes CIGAR-only fetches of long-read BAMs cheap -- the
 * multi-block SEQ/QUAL payload of each record is never decompressed.
 * Returns 0, -1 on corruption/truncation. */
static int bgzf_skip(bgzf_t *z, int64_t n) {
    int zero_blocks = 0;
    while (n > 0) {
        int64_t bsize, isize;
        bgzf_blk_t *b = bgzf_find(z, z->coffset);
        if (b) {
            if (b->eof) return -1;
            isize = b->ulen;
            bsize = b->next_coffset - b->coffset;
        } else {
            int r = bgzf_peek(z, z->coffset, &bsize, &isize);
            if (r != 0) return -1; /* EOF mid-skip = truncated */
        }
        int64_t avail = isize - z->upos;
        if (n < avail) {
            z->upos += (int)n;
            return 0;
        }
        if (avail <= 0 && ++zero_blocks > 8) return -1; /* EOF markers */
        n -= avail > 0 ? avail : 0;
        z->coffset += bsize;
        z->upos = 0;
    }
    return 0;
}


/* ------------------------------------------------------------------ */
/* BAM index: BAI (uncompressed, min_shift=14 depth=5 + linear index)   */
/* and CSI (BGZF-compressed, parameterized binning, per-bin loffset) —  */
/* htslib's sam_index_load transparently accepts both (SURVEY.md §2.13);*/
/* so does this reader: .bai is tried first, then .csi.                 */

typedef struct { uint64_t beg, end; } chunk_t;
typedef struct { uint32_t bin; int32_t n; uint64_t loffset; chunk_t *chunks; } bin_t;
typedef struct {
    int32_t n_bin;
    bin_t *bins;       /* sorted by bin id (binary-searchable) */
    int32_t n_intv;
    uint64_t *ioffset; /* 16 kb linear index (BAI only) */
} ref_idx_t;

typedef struct {
    int32_t n_ref;
    ref_idx_t *refs;
    int min_shift;     /* BAI: 14 */
    int depth;         /* BAI: 5  */
} bai_t;

static int bin_cmp(const void *a, const void *b) {
    uint32_t x = ((const bin_t *)a)->bin, y = ((const bin_t *)b)->bin;
    return x < y ? -1 : (x > y ? 1 : 0);
}

static void idx_sort_bins(bai_t *idx) {
    for (int r = 0; r < idx->n_ref; r++)
        qsort(idx->refs[r].bins, idx->refs[r].n_bin, sizeof(bin_t), bin_cmp);
}

static int bai_load(bai_t *idx, const char *path) {
    FILE *fp = fopen(path, "rb");
    if (!fp) return -1;
    char magic[4];
    if (fread(magic, 1, 4, fp) != 4 || memcmp(magic, "BAI\1", 4)) { fclose(fp); return -1; }
    if (fread(&idx->n_ref, 4, 1, fp) != 1) { fclose(fp); return -1; }
    idx->min_shift = 14;
    idx->depth = 5;
    idx->refs = calloc(idx->n_ref, sizeof(ref_idx_t));
    for (int r = 0; r < idx->n_ref; r++) {
        ref_idx_t *ri = &idx->refs[r];
        if (fread(&ri->n_bin, 4, 1, fp) != 1) goto fail;
        ri->bins = calloc(ri->n_bin, sizeof(bin_t));
        for (int b = 0; b < ri->n_bin; b++) {
            bin_t *bn = &ri->bins[b];
            if (fread(&bn->bin, 4, 1, fp) != 1) goto fail;
            if (fread(&bn->n, 4, 1, fp) != 1) goto fail;
            bn->loffset = 0;
            bn->chunks = malloc(sizeof(chunk_t) * bn->n);
            if (fread(bn->chunks, sizeof(chunk_t), bn->n, fp) != (size_t)bn->n) goto fail;
        }
        if (fread(&ri->n_intv, 4, 1, fp) != 1) goto fail;
        ri->ioffset = malloc(8 * (size_t)ri->n_intv);
        if (ri->n_intv && fread(ri->ioffset, 8, ri->n_intv, fp) != (size_t)ri->n_intv) goto fail;
    }
    fclose(fp);
    idx_sort_bins(idx);
    return 0;
fail:
    fclose(fp);
    return -1;
}

/* CSI: same bin/chunk model, BGZF-compressed, binning parameterized by
 * (min_shift, depth), per-bin loffset instead of a linear index. */
static int csi_load(bai_t *idx, const char *path) {
    bgzf_t z;
    z.fp = fopen(path, "rb");
    if (!z.fp) return -1;
    if (bgzf_init(&z) != 0) { fclose(z.fp); return -1; }
    int ok = -1;
    char magic[4];
    int32_t l_aux;
    if (bgzf_read(&z, magic, 4) != 4 || memcmp(magic, "CSI\1", 4)) goto out;
    int32_t ms, dp;
    if (bgzf_read(&z, &ms, 4) != 4) goto out;
    if (bgzf_read(&z, &dp, 4) != 4) goto out;
    if (bgzf_read(&z, &l_aux, 4) != 4) goto out;
    while (l_aux > 0) {
        char skip[4096];
        int take = l_aux < (int)sizeof(skip) ? l_aux : (int)sizeof(skip);
        if (bgzf_read(&z, skip, take) != take) goto out;
        l_aux -= take;
    }
    if (bgzf_read(&z, &idx->n_ref, 4) != 4) goto out;
    idx->min_shift = ms;
    idx->depth = dp;
    idx->refs = calloc(idx->n_ref, sizeof(ref_idx_t));
    for (int r = 0; r < idx->n_ref; r++) {
        ref_idx_t *ri = &idx->refs[r];
        if (bgzf_read(&z, &ri->n_bin, 4) != 4) goto out;
        ri->bins = calloc(ri->n_bin, sizeof(bin_t));
        for (int b = 0; b < ri->n_bin; b++) {
            bin_t *bn = &ri->bins[b];
            if (bgzf_read(&z, &bn->bin, 4) != 4) goto out;
            if (bgzf_read(&z, &bn->loffset, 8) != 8) goto out;
            if (bgzf_read(&z, &bn->n, 4) != 4) goto out;
            bn->chunks = malloc(sizeof(chunk_t) * bn->n);
            if (bgzf_read(&z, bn->chunks, (int)(sizeof(chunk_t) * bn->n))
                != (int)(sizeof(chunk_t) * bn->n)) goto out;
        }
        ri->n_intv = 0;
        ri->ioffset = NULL;
    }
    idx_sort_bins(idx);
    ok = 0;
out:
    fclose(z.fp);
    bgzf_destroy(&z);
    return ok;
}

/* Shared read-only index registry (VERDICT r2: each producer thread's
 * private handle used to load its own copy of the index — ~70 MB per
 * handle on a 44 MB whole-genome BAI, times 5 handles.  Queries only
 * READ the loaded structure (bins sorted once at load), so handles can
 * share one copy; refcounted, keyed by index path + mtime + size so a
 * rewritten index is never served stale.  The reference pays the
 * per-thread copy (htslib sam_index_load per handle, audit.c:270-272);
 * sharing is strictly better and changes no observable behavior. */
typedef struct idx_entry {
    char *key;
    bai_t idx;
    int refs;
    struct idx_entry *next;
} idx_entry_t;

static idx_entry_t *g_idx_reg = NULL;
static pthread_mutex_t g_idx_mu = PTHREAD_MUTEX_INITIALIZER;

static void bai_free(bai_t *idx);

static const bai_t *idx_acquire(const char *ipath,
                                int (*loader)(bai_t *, const char *)) {
    struct stat st;
    if (stat(ipath, &st) != 0) return NULL;
    char key[4352];
    snprintf(key, sizeof(key), "%s:%lld:%lld", ipath,
             (long long)st.st_mtime, (long long)st.st_size);
    pthread_mutex_lock(&g_idx_mu);
    for (idx_entry_t *e = g_idx_reg; e; e = e->next) {
        if (strcmp(e->key, key) == 0) {
            e->refs++;
            pthread_mutex_unlock(&g_idx_mu);
            return &e->idx;
        }
    }
    idx_entry_t *e = calloc(1, sizeof(*e));
    if (loader(&e->idx, ipath) != 0) {
        pthread_mutex_unlock(&g_idx_mu);
        free(e);
        return NULL;
    }
    e->key = strdup(key);
    e->refs = 1;
    e->next = g_idx_reg;
    g_idx_reg = e;
    pthread_mutex_unlock(&g_idx_mu);
    return &e->idx;
}

static void idx_release(const bai_t *idx) {
    pthread_mutex_lock(&g_idx_mu);
    for (idx_entry_t **pe = &g_idx_reg; *pe; pe = &(*pe)->next) {
        idx_entry_t *e = *pe;
        if (&e->idx == idx) {
            if (--e->refs == 0) {
                *pe = e->next;
                bai_free(&e->idx);
                free(e->key);
                free(e);
            }
            break;
        }
    }
    pthread_mutex_unlock(&g_idx_mu);
}

static void bai_free(bai_t *idx) {
    for (int r = 0; r < idx->n_ref; r++) {
        for (int b = 0; b < idx->refs[r].n_bin; b++) free(idx->refs[r].bins[b].chunks);
        free(idx->refs[r].bins);
        free(idx->refs[r].ioffset);
    }
    free(idx->refs);
}

static const bin_t *find_bin(const ref_idx_t *ri, uint32_t want) {
    int lo = 0, hi = ri->n_bin - 1;
    while (lo <= hi) {
        int mid = (lo + hi) / 2;
        uint32_t v = ri->bins[mid].bin;
        if (v == want) return &ri->bins[mid];
        if (v < want) lo = mid + 1; else hi = mid - 1;
    }
    return NULL;
}

/* bins overlapping [beg, end) for (min_shift, depth) binning, appended
 * to out (vec of uint32).  The CSI generalization of the classic BAI
 * reg2bins table. */
static void overlap_bins(int64_t beg, int64_t end, int min_shift, int depth,
                         vec_t *out) {
    *(uint32_t *)vec_push(out, 1) = 0;
    if (beg >= end) return;
    end--;
    int s = min_shift + depth * 3;
    uint32_t t = 0;
    for (int l = 1; l <= depth; l++) {
        s -= 3;
        t += 1u << ((l - 1) * 3);
        uint32_t lo = t + (uint32_t)(beg >> s);
        uint32_t hi = t + (uint32_t)(end >> s);
        for (uint32_t k = lo; k <= hi; k++)
            *(uint32_t *)vec_push(out, 1) = k;
    }
}

static int chunk_cmp(const void *a, const void *b) {
    const chunk_t *x = a, *y = b;
    if (x->beg != y->beg) return x->beg < y->beg ? -1 : 1;
    return x->end < y->end ? -1 : (x->end > y->end ? 1 : 0);
}

/* ------------------------------------------------------------------ */
/* BAM reader handle                                                    */

typedef struct {
    bgzf_t z;
    const bai_t *idxp;  /* shared, read-only (idx_acquire/idx_release) */
    int has_idx;
    int32_t n_ref;
    int64_t data_voffset;
    /* fetch output buffers (packed read layout) */
    vec_t pos;      /* int64 per read */
    vec_t nops;     /* int32 per read */
    vec_t opoff;    /* int64 per read: start offset into ops/lens */
    vec_t ops;      /* uint8 flattened */
    vec_t lens;     /* int32 flattened */
    vec_t endp;     /* int64 per read: htslib endpos (pos + ref span) */
    vec_t widx;     /* int64: merged-fetch row selection (see
                       svbam_fetch_batch_merged); empty = rows are
                       consecutive per window (plain fetch_batch) */
    uint8_t *rec;   /* record scratch */
    size_t rec_cap;
    /* per-handle scratch: handles are used from multiple threads
       (one handle per producer thread), so no function-static state */
    vec_t binvec;   /* uint32 overlapping-bin scratch */
    vec_t chunkvec; /* chunk_t scratch (per-fetch, reused) */
    /* reference names (BAM header), for name-based tid lookup */
    char **ref_names;
    /* svbam_ins_seqs output: concatenated inserted-base chars +
     * per-insert offsets (n+1) */
    vec_t insbuf;
    vec_t insoff;
    /* svbam_extract_batch's side CSR: the windows past K and within its
     * wide cap (int32 window index), their candidate offsets (int64,
     * n+1) and sorted candidates (int32) */
    vec_t wide_win;
    vec_t wide_off;
    vec_t wide_val;
    /* sticky decode-error detail; "" = no error.  A corrupt/truncated
       BAM must FAIL the fetch, never silently return partial results
       (htslib errors there too; reference use at audit.c:270-272). */
    char errmsg[256];
} svbam_t;

static int32_t rd_i32(const uint8_t *p) { int32_t v; memcpy(&v, p, 4); return v; }
static uint32_t rd_u32(const uint8_t *p) { uint32_t v; memcpy(&v, p, 4); return v; }

void *svbam_open(const char *path) {
    svbam_t *b = calloc(1, sizeof(svbam_t));
    b->z.fp = fopen(path, "rb");
    if (!b->z.fp) { free(b); return NULL; }
    if (bgzf_init(&b->z) != 0) { fclose(b->z.fp); free(b); return NULL; }
    uint8_t magic[4];
    if (bgzf_read(&b->z, magic, 4) != 4 || memcmp(magic, "BAM\1", 4)) goto fail;
    int32_t l_text;
    if (bgzf_read(&b->z, &l_text, 4) != 4) goto fail;
    /* skip header text */
    {
        char skip[4096];
        int left = l_text;
        while (left > 0) {
            int take = left < (int)sizeof(skip) ? left : (int)sizeof(skip);
            if (bgzf_read(&b->z, skip, take) != take) goto fail;
            left -= take;
        }
    }
    if (bgzf_read(&b->z, &b->n_ref, 4) != 4) goto fail;
    b->ref_names = calloc(b->n_ref ? b->n_ref : 1, sizeof(char *));
    for (int i = 0; i < b->n_ref; i++) {
        int32_t l_name, l_ref;
        char name[1024];
        if (bgzf_read(&b->z, &l_name, 4) != 4) goto fail;
        if (l_name > (int)sizeof(name) || l_name < 1) goto fail;
        if (bgzf_read(&b->z, name, l_name) != l_name) goto fail;
        if (bgzf_read(&b->z, &l_ref, 4) != 4) goto fail;
        name[l_name - 1] = 0;  /* NUL-terminated per spec; make sure */
        b->ref_names[i] = strdup(name);
    }
    b->data_voffset = bgzf_tell(&b->z);

    /* htslib's sam_index_load tries .bai then .csi; mirror that. */
    char ipath[4096];
    snprintf(ipath, sizeof(ipath), "%s.bai", path);
    b->idxp = idx_acquire(ipath, bai_load);
    if (!b->idxp) {
        snprintf(ipath, sizeof(ipath), "%s.csi", path);
        b->idxp = idx_acquire(ipath, csi_load);
    }
    b->has_idx = b->idxp != NULL;
    vec_init(&b->binvec, 4);
    vec_init(&b->chunkvec, sizeof(chunk_t));

    vec_init(&b->pos, 8); vec_init(&b->nops, 4); vec_init(&b->opoff, 8);
    vec_init(&b->ops, 1); vec_init(&b->lens, 4);
    vec_init(&b->endp, 8); vec_init(&b->widx, 8);
    vec_init(&b->insbuf, 1); vec_init(&b->insoff, 8);
    return b;
fail:
    fclose(b->z.fp);
    bgzf_destroy(&b->z);
    if (b->ref_names) {
        for (int i = 0; i < b->n_ref; i++) free(b->ref_names[i]);
        free(b->ref_names);
    }
    free(b);
    return NULL;
}

void svbam_close(void *h) {
    svbam_t *b = h;
    if (!b) return;
    fclose(b->z.fp);
    bgzf_destroy(&b->z);
    if (b->idxp) idx_release(b->idxp);
    vec_free(&b->pos); vec_free(&b->nops); vec_free(&b->opoff);
    vec_free(&b->ops); vec_free(&b->lens);
    vec_free(&b->endp); vec_free(&b->widx);
    vec_free(&b->insbuf); vec_free(&b->insoff);
    vec_free(&b->wide_win); vec_free(&b->wide_off); vec_free(&b->wide_val);
    vec_free(&b->binvec);
    vec_free(&b->chunkvec);
    if (b->ref_names) {
        for (int i = 0; i < b->n_ref; i++) free(b->ref_names[i]);
        free(b->ref_names);
    }
    free(b->rec);
    free(b);
}

int32_t svbam_nref(void *h) { return ((svbam_t *)h)->n_ref; }

const char *svbam_ref_name(void *h, int32_t tid) {
    svbam_t *b = h;
    if (tid < 0 || tid >= b->n_ref || !b->ref_names) return "";
    return b->ref_names[tid] ? b->ref_names[tid] : "";
}

/* tid for a reference name; -1 if absent.  Accepts an exact match or a
 * "chr"-prefix difference in either direction (BAM says "chr1", VCF
 * says "1", or vice versa) — htslib callers conventionally handle that
 * themselves; folding it in here keeps --chrom-by-name ergonomic. */
int32_t svbam_tid(void *h, const char *name) {
    svbam_t *b = h;
    if (!b->ref_names || !name) return -1;
    for (int32_t i = 0; i < b->n_ref; i++) {
        const char *rn = b->ref_names[i];
        if (!rn) continue;
        if (strcmp(rn, name) == 0) return i;
        if (strncmp(rn, "chr", 3) == 0 && strcmp(rn + 3, name) == 0) return i;
        if (strncmp(name, "chr", 3) == 0 && strcmp(rn, name + 3) == 0) return i;
    }
    return -1;
}

const char *svbam_error(void *h) { return ((svbam_t *)h)->errmsg; }

/* The handle's inflate counters since the last call, which zeroes them:
 * out[0] ns inside bgzf_inflate_block, out[1] the bytes it produced
 * (cache hits and skipped blocks inflate nothing). */
void svbam_counters(void *h, int64_t *out) {
    bgzf_t *z = &((svbam_t *)h)->z;
    out[0] = z->inflate_ns;
    out[1] = z->inflate_bytes;
    z->inflate_ns = z->inflate_bytes = 0;
}

/* Fetch one region; returns #reads, or -1 with b->errmsg set on any
 * decode failure.  A corrupt or truncated BAM must surface an error,
 * never a silently-partial read set (htslib errors likewise).  Buffers
 * are valid until the next fetch.  Iterator semantics identical to
 * htslib: linear-index lower bound, file-order scan, overlap test
 * pos < end && endpos > beg, stop at pos >= end. */
#define FETCH_ERR(b, ...) do { \
    snprintf((b)->errmsg, sizeof((b)->errmsg), __VA_ARGS__); \
} while (0)

static int64_t fetch_into(svbam_t *b, int32_t tid, int64_t beg, int64_t end) {
    size_t reads_before = b->pos.len;
    const bai_t *ix = b->idxp;
    if (!ix || tid < 0 || tid >= b->n_ref || tid >= ix->n_ref) return 0;
    if (beg < 0) beg = 0;
    if (beg >= end) return 0;
    const ref_idx_t *ri = &ix->refs[tid];

    uint64_t min_off = 0;
    if (ix->min_shift == 14 && ri->n_intv > 0) {  /* BAI linear index */
        int64_t win = beg >> 14;
        if (win >= ri->n_intv) win = ri->n_intv - 1;
        min_off = ri->ioffset[win];
    }

    b->binvec.len = 0;
    overlap_bins(beg, end, ix->min_shift, ix->depth, &b->binvec);
    const uint32_t *binbuf = b->binvec.data;
    size_t nb = b->binvec.len;
    vec_t chunks = b->chunkvec;
    chunks.len = 0;
    for (size_t i = 0; i < nb; i++) {
        const bin_t *bn = find_bin(ri, binbuf[i]);
        if (!bn) continue;
        for (int c = 0; c < bn->n; c++) {
            chunk_t ch = bn->chunks[c];
            if (ch.end <= min_off) continue;
            if (ch.beg < min_off) ch.beg = min_off;
            *(chunk_t *)vec_push(&chunks, 1) = ch;
        }
    }
    qsort(chunks.data, chunks.len, sizeof(chunk_t), chunk_cmp);
    /* merge overlapping/adjacent */
    chunk_t *cs = chunks.data;
    size_t m = 0;
    for (size_t i = 0; i < chunks.len; i++) {
        if (m && cs[i].beg <= cs[m - 1].end) {
            if (cs[i].end > cs[m - 1].end) cs[m - 1].end = cs[i].end;
        } else cs[m++] = cs[i];
    }

    int64_t err = 0;
    for (size_t ci = 0; ci < m && !err; ci++) {
        if (bgzf_seek(&b->z, (int64_t)cs[ci].beg) != 0) {
            FETCH_ERR(b, "BGZF seek to chunk offset %lld failed "
                      "(corrupt or truncated BAM/index)",
                      (long long)cs[ci].beg);
            err = -1;
            break;
        }
        while ((uint64_t)bgzf_tell(&b->z) < cs[ci].end) {
            int32_t bsz;
            int got = bgzf_read(&b->z, &bsz, 4);
            if (got != 4) {
                FETCH_ERR(b, "short read of record length mid-chunk "
                          "(%d/4 bytes): corrupt or truncated BAM", got);
                err = -1;
                goto done;
            }
            if (bsz < 32 || bsz > (64 << 20)) {
                FETCH_ERR(b, "implausible BAM record size %d: corrupt BAM",
                          bsz);
                err = -1;
                goto done;
            }
            /* Only the fixed part + name + CIGAR are ever needed; the
             * SEQ/QUAL/tag payload (the bulk of a long-read record) is
             * bgzf_skip'd — whole skipped blocks are never inflated. */
            if (b->rec_cap < 32) {
                b->rec_cap = 4096;
                b->rec = realloc(b->rec, b->rec_cap);
            }
            got = bgzf_read(&b->z, b->rec, 32);
            if (got != 32) {
                FETCH_ERR(b, "short BAM record read (%d/32 bytes): "
                          "corrupt or truncated BAM", got);
                err = -1;
                goto done;
            }
            int32_t rtid = rd_i32(b->rec);
            int64_t rpos = rd_i32(b->rec + 4);
            uint32_t lrn_flag = rd_u32(b->rec + 8);
            int l_read_name = lrn_flag & 0xff;
            uint32_t ncig_flag = rd_u32(b->rec + 12);
            int n_cigar = ncig_flag & 0xffff;
            int64_t prefix = 32 + l_read_name + 4 * (int64_t)n_cigar;
            if (prefix > bsz) {
                FETCH_ERR(b, "BAM record fields exceed record size "
                          "(%d ops, %d-byte record): corrupt BAM",
                          n_cigar, bsz);
                err = -1;
                goto done;
            }
            if (rtid != tid || rpos >= end) goto done;
            if ((size_t)prefix > b->rec_cap) {
                b->rec_cap = (size_t)prefix * 2;
                b->rec = realloc(b->rec, b->rec_cap);
            }
            got = bgzf_read(&b->z, b->rec + 32, (int)(prefix - 32));
            if (got != (int)(prefix - 32)) {
                FETCH_ERR(b, "short BAM record read (%d/%d bytes): "
                          "corrupt or truncated BAM", got + 32, bsz);
                err = -1;
                goto done;
            }
            if (bgzf_skip(&b->z, bsz - prefix) != 0) {
                FETCH_ERR(b, "BAM record payload skip failed: corrupt "
                          "or truncated BAM");
                err = -1;
                goto done;
            }
            const uint8_t *cig = b->rec + 32 + l_read_name;
            /* endpos */
            int64_t ref_len = 0;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t v = rd_u32(cig + 4 * k);
                uint32_t op = v & 0xf, ln = v >> 4;
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    ref_len += ln;
            }
            int64_t endpos = ref_len > 0 ? rpos + ref_len : rpos + 1;
            if (endpos <= beg) continue;
            *(int64_t *)vec_push(&b->endp, 1) = endpos;
            *(int64_t *)vec_push(&b->pos, 1) = rpos;
            *(int32_t *)vec_push(&b->nops, 1) = n_cigar;
            *(int64_t *)vec_push(&b->opoff, 1) = (int64_t)b->ops.len;
            uint8_t *od = vec_push(&b->ops, n_cigar);
            int32_t *ld = vec_push(&b->lens, n_cigar);
            for (int k = 0; k < n_cigar; k++) {
                uint32_t v = rd_u32(cig + 4 * k);
                od[k] = (uint8_t)(v & 0xf);
                ld[k] = (int32_t)(v >> 4);
            }
        }
    }
done:
    b->chunkvec = chunks;  /* keep the grown scratch for the next fetch */
    if (err) return -1;
    return (int64_t)(b->pos.len - reads_before);
}

int64_t svbam_fetch(void *h, int32_t tid, int64_t beg, int64_t end) {
    svbam_t *b = h;
    b->pos.len = b->nops.len = b->opoff.len = b->ops.len = b->lens.len = 0;
    b->endp.len = b->widx.len = 0;
    b->errmsg[0] = 0;
    return fetch_into(b, tid, beg, end);
}

/* Fetch many regions in one call (one window batch): reads of window i
 * land consecutively, win_counts[i] reads each.  Buffers valid until the
 * next fetch on this handle.  tids[i] < 0 → empty window (skipped I/O,
 * e.g. the refine_point no-op windows).  Returns total reads. */
int64_t svbam_fetch_batch(void *h, int32_t n, const int32_t *tids,
                          const int64_t *begs, const int64_t *ends,
                          int64_t *win_counts) {
    svbam_t *b = h;
    b->pos.len = b->nops.len = b->opoff.len = b->ops.len = b->lens.len = 0;
    b->endp.len = b->widx.len = 0;
    b->errmsg[0] = 0;
    for (int32_t i = 0; i < n; i++) {
        win_counts[i] = fetch_into(b, tids[i], begs[i], ends[i]);
        if (win_counts[i] < 0) return -1;  /* errmsg set by fetch_into */
    }
    return (int64_t)b->pos.len;
}

/* Merged multi-window fetch.  Overlapping audit windows (a DEL's end
 * window inside its start window; neighboring records' windows bridged
 * by long reads; scan mode's adjacent tiles) re-fetch the same reads —
 * the per-read cost is ~1 BGZF block inflate (record prefixes land one
 * per block at long-read record sizes), so duplicate fetches dominate
 * the host pipeline.  This entry sorts the windows by (tid, beg),
 * merges any whose genomic gap is < merge_gap into one region, fetches
 * each region ONCE, and assigns each window the rows of its overlapping
 * reads with the exact htslib iterator test the per-window fetch uses
 * (pos < end && endpos > beg, file order) — so the per-window read sets
 * and their order are identical to svbam_fetch_batch's, each read is
 * decoded once, and windows may SHARE rows.  The row selection
 * (win_counts[i] row indices per window, original window order) is
 * stored on the handle; svbam_extract_batch consumes it transparently.
 * NOT for the svbam_fill path (fill assumes one row per (read, window)
 * instance).  Returns total DISTINCT rows fetched, -1 on decode error. */
typedef struct { int32_t tid; int64_t beg; int32_t i; } wkey_t;

/* (tid, beg, original index) — the index tiebreak keeps the sort
 * stable, so identical windows keep their input order. */
static int wkey_cmp(const void *a, const void *c) {
    const wkey_t *x = a, *y = c;
    if (x->tid != y->tid) return x->tid < y->tid ? -1 : 1;
    if (x->beg != y->beg) return x->beg < y->beg ? -1 : 1;
    return x->i < y->i ? -1 : (x->i > y->i ? 1 : 0);
}

int64_t svbam_fetch_batch_merged(void *h, int32_t n, const int32_t *tids,
                                 const int64_t *begs, const int64_t *ends,
                                 int64_t merge_gap, int64_t *win_counts) {
    svbam_t *b = h;
    b->pos.len = b->nops.len = b->opoff.len = b->ops.len = b->lens.len = 0;
    b->endp.len = b->widx.len = 0;
    b->errmsg[0] = 0;
    if (n <= 0) return 0;

    /* sort window indices by (tid, beg); invalid windows don't fetch */
    wkey_t *keys = malloc((size_t)n * sizeof(wkey_t));
    int64_t *sel_off = malloc((size_t)n * 8);
    int64_t *sel_cnt = calloc((size_t)n, 8);
    vec_t selv; vec_init(&selv, 8);   /* row indices, group order */
    vec_t pmax; vec_init(&pmax, 8);   /* prefix-max endpos scratch */
    int32_t nvalid = 0;
    for (int32_t i = 0; i < n; i++) {
        if (tids[i] >= 0 && begs[i] < ends[i]) {
            keys[nvalid].tid = tids[i];
            keys[nvalid].beg = begs[i] < 0 ? 0 : begs[i];
            keys[nvalid].i = i;
            nvalid++;
        }
        /* invalid/empty window: count stays 0, no fetch (parity with
         * fetch_into's tid<0 / beg>=end empty returns) */
    }
    qsort(keys, nvalid, sizeof(wkey_t), wkey_cmp);

    int64_t err = 0;
    for (int32_t g0 = 0; g0 < nvalid && !err; ) {
        int32_t gtid = keys[g0].tid;
        int64_t gbeg = keys[g0].beg;
        int64_t gend = ends[keys[g0].i];
        int32_t g1 = g0 + 1;
        while (g1 < nvalid && keys[g1].tid == gtid
               && keys[g1].beg <= gend + merge_gap) {
            if (ends[keys[g1].i] > gend) gend = ends[keys[g1].i];
            g1++;
        }
        size_t r0 = b->pos.len;
        if (fetch_into(b, gtid, gbeg, gend) < 0) { err = -1; break; }
        size_t gn = b->pos.len - r0;
        const int64_t *gpos = (const int64_t *)b->pos.data + r0;
        const int64_t *gend_p = (const int64_t *)b->endp.data + r0;
        pmax.len = 0;
        int64_t *pm = vec_push(&pmax, gn ? gn : 1);
        int64_t mx = INT64_MIN;
        for (size_t j = 0; j < gn; j++) {
            if (gend_p[j] > mx) mx = gend_p[j];
            pm[j] = mx;
        }
        for (int32_t k = g0; k < g1; k++) {
            int32_t i = keys[k].i;
            int64_t wbeg = keys[k].beg, wend = ends[i];
            /* lo: first row that could overlap (all before have
             * endpos <= wbeg); hi: first row with pos >= wend (pos is
             * non-decreasing in file order within a region) */
            size_t lo = 0, hi = gn;
            {
                size_t a = 0, c = gn;
                while (a < c) {
                    size_t m = (a + c) / 2;
                    if (pm[m] > wbeg) c = m; else a = m + 1;
                }
                lo = a;
                a = lo; c = gn;
                while (a < c) {
                    size_t m = (a + c) / 2;
                    if (gpos[m] < wend) a = m + 1; else c = m;
                }
                hi = a;
            }
            sel_off[i] = (int64_t)selv.len;
            for (size_t j = lo; j < hi; j++) {
                if (gpos[j] < wend && gend_p[j] > wbeg)
                    *(int64_t *)vec_push(&selv, 1) = (int64_t)(r0 + j);
            }
            sel_cnt[i] = (int64_t)selv.len - sel_off[i];
        }
        g0 = g1;
    }

    int64_t total = (int64_t)b->pos.len;
    if (!err) {
        const int64_t *sv = selv.data;
        for (int32_t i = 0; i < n; i++) {
            win_counts[i] = sel_cnt[i];
            if (sel_cnt[i]) {
                memcpy(vec_push(&b->widx, (size_t)sel_cnt[i]),
                       sv + sel_off[i], (size_t)sel_cnt[i] * 8);
            }
        }
        /* widx empty (every window empty) still means "indexed mode
         * off" downstream, which is correct: all counts are 0. */
    }
    free(keys); free(sel_off); free(sel_cnt);
    vec_free(&selv); vec_free(&pmax);
    return err ? -1 : total;
}

/* Scatter the last fetch into fixed-shape device matrices:
 *   ops_mat  [N,O] int8, lens_mat [N,O] int32
 *   pos/nops/wid [N] int32 (pad rows: pos=0, nops=0, wid=pad_wid)
 * Read r of the fetch goes to row r with window id wid_of_read[r].
 * Cells outside [r < R, k < nops[r]] are left UNINITIALIZED — the
 * device kernel (ops/cigar.py) masks every access by n_ops, so padding
 * bytes are never observed and the memset bandwidth is saved.
 * Reads/ops beyond N/O are the caller's bug (it sized the matrices from
 * this fetch's totals); lengths are clamped defensively anyway. */
void svbam_fill(void *h, const int32_t *wid_of_read,
                int8_t *ops_mat, int32_t *lens_mat,
                int32_t *pos_out, int32_t *nops_out, int32_t *wid_out,
                int64_t N, int64_t O, int32_t pad_wid) {
    svbam_t *b = h;
    int64_t R = (int64_t)b->pos.len;
    if (R > N) R = N;
    const int64_t *pos = b->pos.data;
    const int32_t *nops = b->nops.data;
    const int64_t *opoff = b->opoff.data;
    const uint8_t *ops = b->ops.data;
    const int32_t *lens = b->lens.data;
    for (int64_t r = 0; r < R; r++) {
        int64_t n = nops[r];
        if (n > O) n = O;
        int64_t src = opoff[r];
        int8_t *od = ops_mat + r * O;
        int32_t *ld = lens_mat + r * O;
        for (int64_t k = 0; k < n; k++) od[k] = (int8_t)ops[src + k];
        memcpy(ld, lens + src, (size_t)n * sizeof(int32_t));
        pos_out[r] = (int32_t)pos[r];
        nops_out[r] = (int32_t)n;
        wid_out[r] = wid_of_read[r];
    }
    for (int64_t r = R; r < N; r++) {
        pos_out[r] = 0;
        nops_out[r] = 0;
        wid_out[r] = pad_wid;
    }
}

const int64_t *svbam_read_pos(void *h)  { return ((svbam_t *)h)->pos.data; }
const int32_t *svbam_read_nops(void *h) { return ((svbam_t *)h)->nops.data; }
const int64_t *svbam_read_opoff(void *h){ return ((svbam_t *)h)->opoff.data; }
const uint8_t *svbam_ops(void *h)       { return ((svbam_t *)h)->ops.data; }
const int32_t *svbam_oplens(void *h)    { return ((svbam_t *)h)->lens.data; }
int64_t svbam_total_ops(void *h)        { return (int64_t)((svbam_t *)h)->ops.len; }

/* ------------------------------------------------------------------ */
/* Scalar refinement baseline (reference semantics, fresh C)            */

#define SV_MIN_LEN 50
enum { K_DEL_START = 0, K_DEL_END = 1, K_INS = 2, K_POINT = 3,
       K_INV_END = 4 };

static int cmp_i32(const void *a, const void *b) {
    int32_t x = *(const int32_t *)a, y = *(const int32_t *)b;
    return x < y ? -1 : (x > y ? 1 : 0);
}

static int64_t iabs64(int64_t x) { return x < 0 ? -x : x; }

/* consensus_pos with the reference's sweep/early-return semantics
 * (refinement.c:41-101), written against the same spec as the Python
 * oracle. */
int64_t svbaseline_consensus(int32_t *locs, int64_t n, int64_t pos,
                             int32_t min_count, int32_t interval,
                             int32_t range) {
    if (n < min_count || n == 0) return -1;
    qsort(locs, n, 4, cmp_i32);
    const int half = SV_MIN_LEN / 2;

    int64_t best_l = -1, dist_l = 0x7fffffff, maxc_l = min_count - 1;
    int64_t best_r = -1, dist_r = 0x7fffffff, maxc_r = min_count - 1;

    /* lower_bound: last index <= pos+half, clamped */
    int64_t i = n - 1;
    for (int64_t k = 0; k < n; k++)
        if (locs[k] > pos + half) { i = k ? k - 1 : 0; break; }

    for (; i >= 0 && iabs64(pos - locs[i]) < range; i--) {
        int64_t count = 1;
        uint64_t total = (uint64_t)locs[i];
        for (int64_t j = i - 1; j >= 0 && locs[i] <= locs[j] + interval; j--) {
            count++; total += (uint64_t)locs[j];
        }
        int64_t cand = (int64_t)((total + (uint64_t)(count / 2)) / (uint64_t)count);
        if (count > maxc_l) {
            int64_t d = iabs64(pos - cand);
            if (d < interval) return cand;
            if (d < dist_l) { maxc_l = count; best_l = cand; dist_l = d; }
        }
    }

    /* upper_bound quirk: first index with value < pos-half, else n-1 */
    i = (locs[0] < pos - half) ? 0 : n - 1;
    for (; i < n && iabs64(pos - locs[i]) < range; i++) {
        int64_t count = 1;
        uint64_t total = (uint64_t)locs[i];
        for (int64_t j = i + 1; j < n && locs[j] <= locs[i] + interval; j++) {
            count++; total += (uint64_t)locs[j];
        }
        int64_t cand = (int64_t)((total + (uint64_t)(count / 2)) / (uint64_t)count);
        if (count > maxc_r) {
            int64_t d = iabs64(pos - cand);
            if (d < interval) return cand;
            if (d < dist_r) { maxc_r = count; best_r = cand; dist_r = d; }
        }
    }
    return dist_l < dist_r ? best_l : best_r;
}

/* Evidence walk + consensus for one window over packed reads — the
 * per-record hot loop of the reference (refine_* kernels), used as the
 * CPU baseline for breakpoints/sec. */
/* One read's evidence walk (the refine_* CIGAR loops of
 * refinement.c:103-325), appending candidate positions to `cands`. */
static void extract_read(int32_t kind, const uint8_t *o, const int32_t *l,
                         int n, int64_t rpos, uint32_t istart, uint32_t iend,
                         vec_t *cands) {
    uint32_t rp = (uint32_t)rpos;
    if (kind == K_DEL_START) {
        int check_sc = o[n - 1] == 4;
        for (int k = 0; k < n; k++) {
            if (o[k] == 2 && l[k] > SV_MIN_LEN)
                *(int32_t *)vec_push(cands, 1) = (int32_t)rp;
            if (o[k] != 1 && o[k] != 4) rp += (uint32_t)l[k];
            if (rp > iend) { check_sc = 0; break; }
        }
        if (check_sc && istart <= rp && rp <= iend)
            *(int32_t *)vec_push(cands, 1) = (int32_t)rp;
    } else if (kind == K_DEL_END) {
        for (int k = 0; k < n; k++) {
            if (o[k] == 2 && l[k] > SV_MIN_LEN)
                *(int32_t *)vec_push(cands, 1) = (int32_t)(rp + (uint32_t)l[k] + 1u);
            if (o[k] != 1 && o[k] != 4) rp += (uint32_t)l[k];
            if (rp > iend) break;
        }
        if (o[0] == 4 && istart <= (uint32_t)rpos && (uint32_t)rpos <= iend)
            *(int32_t *)vec_push(cands, 1) = (int32_t)(rp + 1u);
    } else if (kind == K_INS) {
        for (int k = 0; k < n; k++) {
            if (o[k] == 1 && l[k] >= SV_MIN_LEN)
                *(int32_t *)vec_push(cands, 1) = (int32_t)rp;
            if (o[k] != 1 && o[k] != 4) rp += (uint32_t)l[k];
            if (rp > iend) break;
        }
    } else if (kind == K_INV_END) {
        /* --refine-inv extension (no reference analog): D>50 op end+1
         * like K_DEL_END, but a leading soft clip records the actual
         * ALIGNMENT START, not refine_end's post-walk quirk. */
        for (int k = 0; k < n; k++) {
            if (o[k] == 2 && l[k] > SV_MIN_LEN)
                *(int32_t *)vec_push(cands, 1) = (int32_t)(rp + (uint32_t)l[k] + 1u);
            if (o[k] != 1 && o[k] != 4) rp += (uint32_t)l[k];
            if (rp > iend) break;
        }
        if (o[0] == 4 && istart <= (uint32_t)rpos && (uint32_t)rpos <= iend)
            *(int32_t *)vec_push(cands, 1) = (int32_t)(uint32_t)rpos;
    } /* K_POINT: collects nothing (refinement.c:250 quirk) */
}

int64_t svbaseline_refine(int32_t kind,
                          const int64_t *rpos, const int32_t *rnops,
                          const int64_t *ropoff,
                          const uint8_t *ops, const int32_t *lens,
                          int64_t n_reads,
                          int64_t istart, int64_t iend, int64_t ipos,
                          int32_t min_count, int32_t interval,
                          int32_t range) {
    vec_t cands; vec_init(&cands, 4);
    for (int64_t r = 0; r < n_reads; r++) {
        int n = rnops[r];
        if (!n) continue;
        extract_read(kind, ops + ropoff[r], lens + ropoff[r], n, rpos[r],
                     (uint32_t)istart, (uint32_t)iend, &cands);
    }
    int64_t out = svbaseline_consensus(cands.data, (int64_t)cands.len,
                                       ipos, min_count, interval, range);
    vec_free(&cands);
    return out;
}

/* Host-side evidence extraction for the whole last fetch_batch: window
 * w's reads are fetch rows [sum(win_counts[0..w)), +win_counts[w]).
 * Per window: run the reference's evidence walk over its reads, sort the
 * candidates ascending; if count <= K write the row into cands_out
 * (INT32_MAX padded) for the device consensus and set refined_out[w] =
 * INT64_MIN.  A window with K < count <= wide_cap gets a padding row and
 * refined_out[w] = INT64_MIN too, and its sorted candidates go to the
 * handle's side CSR (svbam_wide_*) for a second device pass at the width
 * it needs; past wide_cap the window is refined right here with the
 * scalar consensus (the device never sees it).  counts_out[w] = true
 * candidate count.
 *
 * This is the bandwidth-optimal feed for a remote accelerator: K int32s
 * per window instead of every read's full CIGAR (the walk is
 * memory-bound irregular integer work; the consensus sweep is the part
 * that vectorizes). */
void svbam_extract_batch(void *h, int32_t nwin, const int32_t *kinds,
                         const int64_t *istart, const int64_t *iend,
                         const int64_t *ipos, const int64_t *win_counts,
                         int32_t K, int32_t wide_cap, int32_t min_count,
                         int32_t interval, int32_t range,
                         int32_t *cands_out, int32_t *counts_out,
                         int64_t *refined_out) {
    svbam_t *b = h;
    const int64_t *rpos = b->pos.data;
    const int32_t *rnops = b->nops.data;
    const int64_t *ropoff = b->opoff.data;
    const uint8_t *ops = b->ops.data;
    const int32_t *lens = b->lens.data;
    /* merged-fetch mode: window w's reads are the widx rows
     * [sum(win_counts[0..w)), +win_counts[w]) instead of consecutive
     * fetch rows (svbam_fetch_batch_merged) */
    const int64_t *widx = b->widx.len ? (const int64_t *)b->widx.data : NULL;
    /* the side CSR is the handle's, its buffers reused from call to call */
    b->wide_win.esz = 4; b->wide_off.esz = 8; b->wide_val.esz = 4;
    b->wide_win.len = b->wide_off.len = b->wide_val.len = 0;
    *(int64_t *)vec_push(&b->wide_off, 1) = 0;
    vec_t cands; vec_init(&cands, 4);
    int64_t row = 0;
    for (int32_t w = 0; w < nwin; w++) {
        cands.len = 0;
        for (int64_t t = row; t < row + win_counts[w]; t++) {
            int64_t r = widx ? widx[t] : t;
            int n = rnops[r];
            if (!n) continue;
            extract_read(kinds[w], ops + ropoff[r], lens + ropoff[r], n,
                         rpos[r], (uint32_t)istart[w], (uint32_t)iend[w],
                         &cands);
        }
        row += win_counts[w];
        counts_out[w] = (int32_t)cands.len;
        int32_t *dst = cands_out + (int64_t)w * K;
        int64_t n = (int64_t)cands.len;
        if (n <= (int64_t)K) {
            if (n) {
                qsort(cands.data, n, 4, cmp_i32);
                memcpy(dst, cands.data, n * 4);
            }
            for (int64_t k = n; k < K; k++) dst[k] = 0x7fffffff;
            refined_out[w] = INT64_MIN;
        } else if (n <= (int64_t)wide_cap) {
            for (int32_t k = 0; k < K; k++) dst[k] = 0x7fffffff;
            qsort(cands.data, n, 4, cmp_i32);
            memcpy(vec_push(&b->wide_val, n), cands.data, n * 4);
            *(int32_t *)vec_push(&b->wide_win, 1) = w;
            *(int64_t *)vec_push(&b->wide_off, 1) = (int64_t)b->wide_val.len;
            refined_out[w] = INT64_MIN;
        } else {
            for (int32_t k = 0; k < K; k++) dst[k] = 0x7fffffff;
            refined_out[w] = svbaseline_consensus(
                cands.data, n, ipos[w], min_count, interval, range);
        }
    }
    vec_free(&cands);
}

/* The side CSR of the last svbam_extract_batch: its window count, and
 * its window indices [n], offsets [n+1] and candidates [offsets[n]]. */
int64_t svbam_wide_n(void *h) {
    return (int64_t)((svbam_t *)h)->wide_win.len;
}
const int32_t *svbam_wide_win(void *h) {
    return ((svbam_t *)h)->wide_win.data;
}
const int64_t *svbam_wide_off(void *h) {
    return ((svbam_t *)h)->wide_off.data;
}
const int32_t *svbam_wide_val(void *h) {
    return ((svbam_t *)h)->wide_val.data;
}

/* ================================================================== */
/* GAF fast path (disc mode)                                           */
/*                                                                     */
/* Tokenizes GAF lines and projects each read's graph alignment onto   */
/* the rank-0 backbone, emitting CSR run arrays ready for the batched  */
/* device scan.  Semantics mirror io/gaf.py (iter_gaf ->               */
/* parse_gaf_line / parse_nodes / project_alignment) EXACTLY — the     */
/* completed form of the reference's WIP parse_gaf projection loop     */
/* (discover.c:46-246) — and are golden-tested against the Python path */
/* (tests/test_gaf_native.py).  This is the BAM-reader treatment       */
/* applied to GAF: the Python path spent ~80% of disc wall time in     */
/* regex/string work per read (VERDICT r3 missing #2).                 */

/* CIGAR op codes, BAM encoding order MIDNSHP=X (constants.py). */
#define GOP_M 0
#define GOP_I 1
#define GOP_D 2
#define GOP_S 4
/* ref ops: M,D,=,X ; query ops: M,I,S,=,X (io/gaf.py:41-42) */
static inline int gaf_is_ref(int op)   { return op==0||op==2||op==7||op==8; }
static inline int gaf_is_query(int op) { return op==0||op==1||op==4||op==7||op==8; }

static const int8_t GAF_OPCODE[256] = {
    ['M']=0, ['I']=1, ['D']=2, ['N']=3, ['S']=4, ['H']=5, ['P']=6,
    ['=']=7, ['X']=8,
};
static const uint8_t GAF_ISOP[256] = {
    ['M']=1, ['I']=1, ['D']=1, ['N']=1, ['S']=1, ['H']=1, ['P']=1,
    ['=']=1, ['X']=1,
};

/* open-addressing string set (read-name dedupe, discover.c:97-102).
 * Stores offsets+1 into a name pool; FNV-1a hashing. */
typedef struct {
    uint64_t *slot;          /* pool_offset+1, 0 = empty */
    size_t cap, n;
    vec_t pool;              /* NUL-terminated names */
} strset_t;

static uint64_t fnv1a(const char *s, size_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; i++) { h ^= (uint8_t)s[i]; h *= 1099511628211ULL; }
    return h;
}

static void strset_init(strset_t *t) {
    t->cap = 1 << 16; t->n = 0;
    t->slot = calloc(t->cap, 8);
    vec_init(&t->pool, 1);
}
static void strset_free(strset_t *t) { free(t->slot); vec_free(&t->pool); }

static void strset_grow(strset_t *t) {
    size_t ncap = t->cap * 2;
    uint64_t *ns = calloc(ncap, 8);
    const char *pool = t->pool.data;
    for (size_t i = 0; i < t->cap; i++) {
        if (!t->slot[i]) continue;
        const char *s = pool + (t->slot[i] - 1);
        size_t j = fnv1a(s, strlen(s)) & (ncap - 1);
        while (ns[j]) j = (j + 1) & (ncap - 1);
        ns[j] = t->slot[i];
    }
    free(t->slot); t->slot = ns; t->cap = ncap;
}

/* returns 1 if s was already present, else inserts it and returns 0. */
static int strset_check_add(strset_t *t, const char *s, size_t len) {
    if (t->n * 10 >= t->cap * 7) strset_grow(t);
    size_t j = fnv1a(s, len) & (t->cap - 1);
    const char *pool = t->pool.data;
    while (t->slot[j]) {
        const char *q = pool + (t->slot[j] - 1);
        if (!strncmp(q, s, len) && !q[len]) return 1;
        j = (j + 1) & (t->cap - 1);
    }
    size_t off = t->pool.len;
    char *dst = vec_push(&t->pool, len + 1);
    memcpy(dst, s, len); dst[len] = 0;
    t->slot[j] = off + 1;
    t->n++;
    return 0;
}

typedef struct {
    FILE *fp;
    char *line; size_t linecap;
    /* segment table, sorted by id (from parse_gfa) */
    int64_t n_segs;
    int64_t *seg_id;
    int32_t *seg_rank;
    int64_t *seg_start, *seg_end, *seg_len;
    strset_t seen;
    /* scratch */
    vec_t cig_op, cig_len;       /* parsed cigar runs (int8 / int64) */
    vec_t nodes;                 /* node indices (int64) */
    /* per-batch outputs (CSR) */
    vec_t nruns;                 /* int32 per read */
    vec_t runoff;                /* int64 per read (start into flat) */
    vec_t flat_op;               /* int8 */
    vec_t flat_len;              /* int32 */
    vec_t refstart;              /* int64 per read */
    vec_t rc;                    /* uint8 per read */
    vec_t rmeta;                 /* int32 x3 per read: len,start,end */
    vec_t names; vec_t nameoff;  /* char pool; int64 per read+1 */
    vec_t errnames; vec_t erroff;/* invalid-path read names (per batch) */
    char errmsg[256];
} svgaf_t;

void *svgaf_open(const char *path, int64_t n_segs, const int64_t *seg_id,
                 const int32_t *seg_rank, const int64_t *seg_start,
                 const int64_t *seg_end, const int64_t *seg_len) {
    svgaf_t *g = calloc(1, sizeof(*g));
    if (!g) return NULL;
    g->fp = fopen(path, "r");
    if (!g->fp) { free(g); return NULL; }
    g->n_segs = n_segs;
    size_t sz8 = n_segs * 8, sz4 = n_segs * 4;
    g->seg_id = malloc(sz8); memcpy(g->seg_id, seg_id, sz8);
    g->seg_rank = malloc(sz4); memcpy(g->seg_rank, seg_rank, sz4);
    g->seg_start = malloc(sz8); memcpy(g->seg_start, seg_start, sz8);
    g->seg_end = malloc(sz8); memcpy(g->seg_end, seg_end, sz8);
    g->seg_len = malloc(sz8); memcpy(g->seg_len, seg_len, sz8);
    strset_init(&g->seen);
    vec_init(&g->cig_op, 1); vec_init(&g->cig_len, 8);
    vec_init(&g->nodes, 8);
    vec_init(&g->nruns, 4); vec_init(&g->runoff, 8);
    vec_init(&g->flat_op, 1); vec_init(&g->flat_len, 4);
    vec_init(&g->refstart, 8); vec_init(&g->rc, 1);
    vec_init(&g->rmeta, 4);
    vec_init(&g->names, 1); vec_init(&g->nameoff, 8);
    vec_init(&g->errnames, 1); vec_init(&g->erroff, 8);
    return g;
}

void svgaf_close(void *h) {
    svgaf_t *g = h;
    if (!g) return;
    if (g->fp) fclose(g->fp);
    free(g->line);
    free(g->seg_id); free(g->seg_rank); free(g->seg_start);
    free(g->seg_end); free(g->seg_len);
    strset_free(&g->seen);
    vec_free(&g->cig_op); vec_free(&g->cig_len); vec_free(&g->nodes);
    vec_free(&g->nruns); vec_free(&g->runoff);
    vec_free(&g->flat_op); vec_free(&g->flat_len);
    vec_free(&g->refstart); vec_free(&g->rc); vec_free(&g->rmeta);
    vec_free(&g->names); vec_free(&g->nameoff);
    vec_free(&g->errnames); vec_free(&g->erroff);
    free(g);
}

static int64_t gaf_find_seg(svgaf_t *g, int64_t id) {
    int64_t lo = 0, hi = g->n_segs - 1;
    while (lo <= hi) {
        int64_t mid = (lo + hi) >> 1;
        if (g->seg_id[mid] < id) lo = mid + 1;
        else if (g->seg_id[mid] > id) hi = mid - 1;
        else return mid;
    }
    return -1;
}

/* append one run, merging with the previous run of the same op
 * (io/gaf.py project_alignment's emit closure). */
static inline void gaf_emit(vec_t *fop, vec_t *flen, size_t base,
                            int op, int64_t ln) {
    if (ln <= 0) return;
    size_t n = fop->len;
    if (n > base && ((int8_t *)fop->data)[n - 1] == (int8_t)op) {
        ((int32_t *)flen->data)[n - 1] += (int32_t)ln;
        return;
    }
    *(int8_t *)vec_push(fop, 1) = (int8_t)op;
    *(int32_t *)vec_push(flen, 1) = (int32_t)ln;
}

/* Fill the batch vectors with up to max_reads projected reads.
 * Returns the number of reads produced (0 = EOF). */
int64_t svgaf_next_batch(void *h, int64_t max_reads) {
    svgaf_t *g = h;
    g->nruns.len = g->runoff.len = 0;
    g->flat_op.len = g->flat_len.len = 0;
    g->refstart.len = g->rc.len = g->rmeta.len = 0;
    g->names.len = g->nameoff.len = 0;
    g->errnames.len = g->erroff.len = 0;
    *(int64_t *)vec_push(&g->nameoff, 1) = 0;
    *(int64_t *)vec_push(&g->erroff, 1) = 0;

    int64_t count = 0;
    ssize_t got;
    while (count < max_reads && (got = getline(&g->line, &g->linecap, g->fp)) != -1) {
        char *ln = g->line;
        if (got && ln[got - 1] == '\n') ln[--got] = 0;
        if (!got) continue;
        /* tab-split the 12 mandatory columns (parse_gaf_line) */
        char *f[12]; int nf = 0;
        char *p = ln;
        f[nf++] = p;
        while (nf < 12 && (p = strchr(p, '\t'))) { *p++ = 0; f[nf++] = p; }
        if (nf < 12) continue;
        char *rest = strchr(f[11], '\t');       /* tag region (may be NULL) */
        if (rest) *rest++ = 0;
        int64_t qual = strtoll(f[11], NULL, 10);
        if (qual == 0) continue;                 /* discover.c:89 */
        const char *name = f[0];
        size_t namelen = strlen(name);
        int64_t read_len = strtoll(f[1], NULL, 10);
        int64_t read_start = strtoll(f[2], NULL, 10);
        int64_t read_end = strtoll(f[3], NULL, 10);
        const char *path = f[5];
        int64_t path_len = strtoll(f[6], NULL, 10);
        int64_t path_start = strtoll(f[7], NULL, 10);
        int64_t path_end = strtoll(f[8], NULL, 10);
        (void)path_end;
        /* cg:Z: tag */
        char *cg = NULL;
        for (char *t = rest; t; ) {
            char *next = strchr(t, '\t');
            if (next) *next++ = 0;
            if (!strncmp(t, "cg:Z:", 5)) cg = t + 5;  /* last one wins */
            t = next;
        }
        /* dedupe BEFORE validation?  No: iter_gaf marks a read seen only
         * after successful projection, so a rejected first alignment
         * does NOT shadow a later valid one.  Check membership here,
         * insert after projecting. */
        {
            size_t j = fnv1a(name, namelen) & (g->seen.cap - 1);
            const char *pool = g->seen.pool.data;
            int dup = 0;
            while (g->seen.slot[j]) {
                const char *q = pool + (g->seen.slot[j] - 1);
                if (!strncmp(q, name, namelen) && !q[namelen]) { dup = 1; break; }
                j = (j + 1) & (g->seen.cap - 1);
            }
            if (dup) continue;
        }
        /* parse + validate path nodes (parse_nodes, discover.c:9-44) */
        g->nodes.len = 0;
        int fwd = 0, rev = 0, bad = 0;
        for (const char *t = path; *t; ) {
            if (*t != '<' && *t != '>') { t++; continue; }
            char strand = *t++;
            if (*t < '0' || *t > '9') continue;
            int64_t id = 0;
            while (*t >= '0' && *t <= '9') id = id * 10 + (*t++ - '0');
            int64_t si = gaf_find_seg(g, id);
            if (si < 0 || g->seg_rank[si] > 1) { bad = 1; break; }
            if (strand == '>') fwd++; else rev++;
            if (fwd && rev) { bad = 1; break; }
            *(int64_t *)vec_push(&g->nodes, 1) = si;
        }
        if (bad || g->nodes.len == 0) {
            /* record the error name (run_discover's [ERROR] lines) */
            char *dst = vec_push(&g->errnames, namelen);
            memcpy(dst, name, namelen);
            *(int64_t *)vec_push(&g->erroff, 1) = (int64_t)g->errnames.len;
            continue;
        }
        if (!cg) continue;                       /* no cigar: skip, not seen */

        int is_rc = path[0] == '<';
        int64_t n_nodes = g->nodes.len;
        int64_t *nodes = g->nodes.data;
        if (is_rc) {
            for (int64_t i = 0; i < n_nodes / 2; i++) {
                int64_t tmp = nodes[i];
                nodes[i] = nodes[n_nodes - 1 - i];
                nodes[n_nodes - 1 - i] = tmp;
            }
        }
        /* fix_indices on rc (utils.c:37-43) */
        int64_t rs = read_start, re = read_end;
        if (is_rc) {
            path_start = path_len - path_end;
            rs = read_len - read_end; re = read_len - read_start;
        }

        /* parse cigar runs (parse_cigar_runs; reversed when rc) */
        g->cig_op.len = g->cig_len.len = 0;
        for (const char *t = cg; *t; ) {
            int64_t v = 0; int any = 0;
            while (*t >= '0' && *t <= '9') { v = v * 10 + (*t - '0'); t++; any = 1; }
            if (!any || !GAF_ISOP[(uint8_t)*t]) { if (!*t) break; t++; continue; }
            *(int8_t *)vec_push(&g->cig_op, 1) = GAF_OPCODE[(uint8_t)*t];
            *(int64_t *)vec_push(&g->cig_len, 1) = v;
            t++;
        }
        int64_t n_cig = g->cig_op.len;
        int8_t *cop = g->cig_op.data;
        int64_t *clen = g->cig_len.data;
        if (is_rc) {
            for (int64_t i = 0; i < n_cig / 2; i++) {
                int8_t to = cop[i]; cop[i] = cop[n_cig - 1 - i]; cop[n_cig - 1 - i] = to;
                int64_t tl = clen[i]; clen[i] = clen[n_cig - 1 - i]; clen[n_cig - 1 - i] = tl;
            }
        }

        size_t run_base = g->flat_op.len;
        int64_t reference_start;

        /* fast path: single rank-0 node whose remaining length covers
         * the whole alignment (io/gaf.py:170-187) */
        int64_t s0 = nodes[0];
        int fast = 0;
        if (n_nodes == 1 && g->seg_rank[s0] == 0) {
            int64_t ref_need = 0;
            for (int64_t i = 0; i < n_cig; i++)
                if (gaf_is_ref(cop[i])) ref_need += clen[i];
            if (ref_need <= g->seg_len[s0] - path_start) {
                gaf_emit(&g->flat_op, &g->flat_len, run_base, GOP_S, rs);
                for (int64_t i = 0; i < n_cig; i++)
                    gaf_emit(&g->flat_op, &g->flat_len, run_base, cop[i], clen[i]);
                gaf_emit(&g->flat_op, &g->flat_len, run_base, GOP_S, read_len - re);
                reference_start = g->seg_start[s0] + path_start;
                fast = 1;
            }
        }
        if (!fast) {
            /* general projection loop (io/gaf.py:189-232) */
            gaf_emit(&g->flat_op, &g->flat_len, run_base, GOP_S, rs);
            int64_t ni = 0, seg = nodes[0];
            int64_t prev_ref = g->seg_rank[seg] == 0 ? seg : -1;
            int64_t p_rem = g->seg_len[seg] - path_start;
            int ref_set = g->seg_rank[seg] == 0;
            reference_start = ref_set ? g->seg_start[seg] + path_start : -1;
            int done = 0;
            for (int64_t i = 0; i < n_cig && !done; i++) {
                int op = cop[i];
                int64_t lnn = clen[i];
                while (lnn > 0 && !done) {
                    int64_t take = gaf_is_ref(op)
                        ? (lnn < p_rem ? lnn : p_rem) : lnn;
                    if (g->seg_rank[seg] == 0)
                        gaf_emit(&g->flat_op, &g->flat_len, run_base, op, take);
                    else if (gaf_is_query(op))
                        gaf_emit(&g->flat_op, &g->flat_len, run_base, GOP_I, take);
                    lnn -= take;
                    if (!gaf_is_ref(op)) break;
                    p_rem -= take;
                    if (p_rem > 0) continue;
                    ni++;
                    if (ni == n_nodes) { done = 1; break; }
                    seg = nodes[ni];
                    p_rem = g->seg_len[seg];
                    if (g->seg_rank[seg] == 0) {
                        if (!ref_set) {
                            reference_start = g->seg_start[seg];
                            ref_set = 1;
                        }
                        if (prev_ref >= 0 &&
                            g->seg_start[seg] > g->seg_end[prev_ref])
                            gaf_emit(&g->flat_op, &g->flat_len, run_base,
                                     GOP_D, g->seg_start[seg] - g->seg_end[prev_ref]);
                        prev_ref = seg;
                    }
                }
            }
            gaf_emit(&g->flat_op, &g->flat_len, run_base, GOP_S, read_len - re);
            if (!ref_set) reference_start = -1;
        }

        /* commit the read */
        strset_check_add(&g->seen, name, namelen);
        *(int32_t *)vec_push(&g->nruns, 1) = (int32_t)(g->flat_op.len - run_base);
        *(int64_t *)vec_push(&g->runoff, 1) = (int64_t)run_base;
        *(int64_t *)vec_push(&g->refstart, 1) = reference_start;
        *(uint8_t *)vec_push(&g->rc, 1) = (uint8_t)is_rc;
        int32_t *m = vec_push(&g->rmeta, 3);
        m[0] = (int32_t)read_len; m[1] = (int32_t)rs; m[2] = (int32_t)re;
        char *nd = vec_push(&g->names, namelen);
        memcpy(nd, name, namelen);
        *(int64_t *)vec_push(&g->nameoff, 1) = (int64_t)g->names.len;
        count++;
    }
    return count;
}

/* batch accessors (valid until the next svgaf_next_batch call) */
const int32_t *svgaf_nruns(void *h)    { return ((svgaf_t *)h)->nruns.data; }
const int64_t *svgaf_runoff(void *h)   { return ((svgaf_t *)h)->runoff.data; }
const int8_t  *svgaf_ops(void *h)      { return ((svgaf_t *)h)->flat_op.data; }
const int32_t *svgaf_oplens(void *h)   { return ((svgaf_t *)h)->flat_len.data; }
int64_t        svgaf_total_runs(void *h){ return (int64_t)((svgaf_t *)h)->flat_op.len; }
const int64_t *svgaf_refstart(void *h) { return ((svgaf_t *)h)->refstart.data; }
const uint8_t *svgaf_rc(void *h)       { return ((svgaf_t *)h)->rc.data; }
const int32_t *svgaf_rmeta(void *h)    { return ((svgaf_t *)h)->rmeta.data; }
const char    *svgaf_names(void *h)    { return ((svgaf_t *)h)->names.data; }
const int64_t *svgaf_nameoff(void *h)  { return ((svgaf_t *)h)->nameoff.data; }
int64_t        svgaf_err_count(void *h){ return (int64_t)((svgaf_t *)h)->erroff.len - 1; }
const char    *svgaf_err_names(void *h){ return ((svgaf_t *)h)->errnames.data; }
const int64_t *svgaf_erroff(void *h)   { return ((svgaf_t *)h)->erroff.data; }

/* ================================================================== */
/* INS consensus support: SEQ decoding for inserted segments            */
/*                                                                     */
/* The prefix-parse fetch path deliberately skips the SEQ/QUAL payload */
/* (fetch_into).  The audt-mode POA consensus path (--ins-consensus,   */
/* the capability slot of the reference's built-but-unused abPOA       */
/* submodule, .gitmodules:5-7, and the MSA TODO at discover.c:401)     */
/* needs the inserted bases themselves: for each read overlapping a    */
/* refined INS site, decode the SEQ substring of every I op >= min_len */
/* whose reference position (refine_ins convention: rp advances for    */
/* every op that is not I and not S, refinement.c:137-139 quirk        */
/* included) lies within [lo, hi].                                     */

static const char SEQ_NT16[16] = "=ACMGRSVTWYHKDBN";

int64_t svbam_ins_seqs(void *h, int32_t tid, int64_t beg, int64_t end,
                       int32_t min_len, int64_t lo, int64_t hi) {
    svbam_t *b = h;
    b->insbuf.len = b->insoff.len = 0;
    b->errmsg[0] = 0;
    *(int64_t *)vec_push(&b->insoff, 1) = 0;

    const bai_t *ix = b->idxp;
    if (!ix || tid < 0 || tid >= b->n_ref || tid >= ix->n_ref) return 0;
    if (beg < 0) beg = 0;
    if (beg >= end) return 0;
    const ref_idx_t *ri = &ix->refs[tid];

    uint64_t min_off = 0;
    if (ix->min_shift == 14 && ri->n_intv > 0) {
        int64_t win = beg >> 14;
        if (win >= ri->n_intv) win = ri->n_intv - 1;
        min_off = ri->ioffset[win];
    }
    b->binvec.len = 0;
    overlap_bins(beg, end, ix->min_shift, ix->depth, &b->binvec);
    const uint32_t *binbuf = b->binvec.data;
    vec_t chunks = b->chunkvec;
    chunks.len = 0;
    for (size_t i = 0; i < b->binvec.len; i++) {
        const bin_t *bn = find_bin(ri, binbuf[i]);
        if (!bn) continue;
        for (int c = 0; c < bn->n; c++) {
            chunk_t ch = bn->chunks[c];
            if (ch.end <= min_off) continue;
            if (ch.beg < min_off) ch.beg = min_off;
            *(chunk_t *)vec_push(&chunks, 1) = ch;
        }
    }
    qsort(chunks.data, chunks.len, sizeof(chunk_t), chunk_cmp);
    chunk_t *cs = chunks.data;
    size_t m = 0;
    for (size_t i = 0; i < chunks.len; i++) {
        if (m && cs[i].beg <= cs[m - 1].end) {
            if (cs[i].end > cs[m - 1].end) cs[m - 1].end = cs[i].end;
        } else cs[m++] = cs[i];
    }

    int64_t err = 0;
    for (size_t ci = 0; ci < m && !err; ci++) {
        if (bgzf_seek(&b->z, (int64_t)cs[ci].beg) != 0) {
            FETCH_ERR(b, "BGZF seek to chunk offset %lld failed",
                      (long long)cs[ci].beg);
            err = -1;
            break;
        }
        while ((uint64_t)bgzf_tell(&b->z) < cs[ci].end) {
            int32_t bsz;
            int got = bgzf_read(&b->z, &bsz, 4);
            if (got != 4) { FETCH_ERR(b, "short record length read"); err = -1; goto done; }
            if (bsz < 32 || bsz > (64 << 20)) {
                FETCH_ERR(b, "implausible BAM record size %d", bsz);
                err = -1; goto done;
            }
            /* full record this time: SEQ is needed */
            if ((size_t)bsz > b->rec_cap) {
                b->rec_cap = (size_t)bsz * 2;
                b->rec = realloc(b->rec, b->rec_cap);
            }
            got = bgzf_read(&b->z, b->rec, bsz);
            if (got != bsz) { FETCH_ERR(b, "short BAM record read"); err = -1; goto done; }
            int32_t rtid = rd_i32(b->rec);
            int64_t rpos = rd_i32(b->rec + 4);
            if (rtid != tid || rpos >= end) goto done;
            int l_read_name = rd_u32(b->rec + 8) & 0xff;
            int n_cigar = rd_u32(b->rec + 12) & 0xffff;
            int64_t l_seq = rd_i32(b->rec + 16);
            int64_t cig_off = 32 + l_read_name;
            int64_t seq_off = cig_off + 4 * (int64_t)n_cigar;
            if (seq_off + (l_seq + 1) / 2 > bsz) {
                FETCH_ERR(b, "BAM record fields exceed record size");
                err = -1; goto done;
            }
            const uint8_t *cig = b->rec + cig_off;
            const uint8_t *seq = b->rec + seq_off;
            /* overlap test needs endpos */
            int64_t ref_len = 0;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t v = rd_u32(cig + 4 * k);
                uint32_t op = v & 0xf;
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    ref_len += v >> 4;
            }
            int64_t endpos = ref_len > 0 ? rpos + ref_len : rpos + 1;
            if (endpos <= beg) continue;
            if (l_seq <= 0) continue;      /* SEQ "*": nothing to decode */
            /* refine_ins-convention walk with query tracking */
            uint32_t rp = (uint32_t)rpos;
            int64_t qpos = 0;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t v = rd_u32(cig + 4 * k);
                uint32_t op = v & 0xf, ln = v >> 4;
                if (op == 1 && (int32_t)ln >= min_len &&
                    (int64_t)rp >= lo && (int64_t)rp <= hi &&
                    qpos + ln <= l_seq) {
                    char *dst = vec_push(&b->insbuf, ln);
                    for (uint32_t t = 0; t < ln; t++) {
                        int64_t qi = qpos + t;
                        uint8_t byte = seq[qi >> 1];
                        dst[t] = SEQ_NT16[(qi & 1) ? (byte & 0xf)
                                                   : (byte >> 4)];
                    }
                    *(int64_t *)vec_push(&b->insoff, 1) =
                        (int64_t)b->insbuf.len;
                }
                if (op != 1 && op != 4) rp += ln;   /* quirk ref advance */
                if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8)
                    qpos += ln;                     /* query advance */
            }
        }
    }
done:
    b->chunkvec = chunks;
    if (err) return -1;
    return (int64_t)(b->insoff.len - 1);
}

const char *svbam_ins_buf(void *h) { return ((svbam_t *)h)->insbuf.data; }
const int64_t *svbam_ins_off(void *h) { return ((svbam_t *)h)->insoff.data; }
