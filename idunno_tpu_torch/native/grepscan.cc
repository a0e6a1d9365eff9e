// Native log-scan engine for the distributed grep service.
//
// The reference's grep subsystem (mp1_client/mp1_server, imported at
// `mp4_machinelearning.py:15-16` but missing from the repo) scanned VM logs
// in Python. Serving-cluster logs run to the rotating-file cap (100 MB,
// `mp4_machinelearning.py:62-74`); scanning them line-by-line in Python is
// ~100x slower than memory bandwidth. This scanner mmaps the file and
// OpenMP-splits it into newline-aligned chunks; each thread memmem-scans
// its chunk for a literal needle and records matching line-start offsets.
// Regex patterns stay on the Python fallback path (the distributed grep).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Scan `path` for lines containing the literal `needle`.
// Returns total matching-line count, or -1 on I/O error. Writes up to `cap`
// matching line-start offsets (ascending) and the number written.
int64_t grep_literal(const char* path, const char* needle,
                     int64_t* offsets, int64_t cap, int64_t* n_written) {
    *n_written = 0;
    const int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st {};
    if (fstat(fd, &st) != 0) {
        close(fd);
        return -1;
    }
    if (st.st_size == 0) {
        close(fd);
        return 0;
    }
    const size_t size = (size_t)st.st_size;
    const char* data =
        (const char*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (data == MAP_FAILED) return -1;

    const size_t nlen = strlen(needle);
    int n_chunks = 1;
#ifdef _OPENMP
    n_chunks = (int)std::min<size_t>(16, std::max<size_t>(1, size >> 22));
#endif
    std::vector<int64_t> counts(n_chunks, 0);
    std::vector<std::vector<int64_t>> hits(n_chunks);

#pragma omp parallel for schedule(static)
    for (int c = 0; c < n_chunks; ++c) {
        // chunk c owns lines whose first byte lies in [lo, hi)
        size_t lo = size * c / n_chunks, hi = size * (c + 1) / n_chunks;
        if (c > 0) {   // advance to the first line START inside the chunk
            const char* nl = (const char*)memchr(data + lo - 1, '\n',
                                                 size - lo + 1);
            lo = nl ? (size_t)(nl - data) + 1 : size;
        }
        size_t pos = lo;
        while (pos < hi) {
            const char* nl = (const char*)memchr(data + pos, '\n',
                                                 size - pos);
            const size_t line_end = nl ? (size_t)(nl - data) : size;
            if (nlen == 0 ||
                memmem(data + pos, line_end - pos, needle, nlen)) {
                ++counts[c];
                hits[c].push_back((int64_t)pos);
            }
            pos = line_end + 1;
        }
    }

    munmap((void*)data, size);
    int64_t total = 0, written = 0;
    for (int c = 0; c < n_chunks; ++c) {
        total += counts[c];
        for (int64_t off : hits[c])
            if (written < cap) offsets[written++] = off;
    }
    *n_written = written;
    return total;
}

}  // extern "C"
