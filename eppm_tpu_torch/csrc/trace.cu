// The tracer's device marks (eppm_tpu_torch/utils/trace.py) and the count
// of a CUDA graph's nodes.
//
// Replaces no TPU kernel: the JAX package has no tracer of its own.  A mark
// is one thread that writes the card's %globaltimer (ns) into slot `slot`
// of one row of a ring held in device memory.  The row is the count of
// sequences finished on the device modulo TRACE_ROWS; the sequence's last
// mark also writes the count into the row's `seq` word and bumps it.  A
// CUDA graph captured with marks in it therefore stamps every replay into a
// fresh row, with no host work and no synchronisation: the host reads the
// ring once, when the trace is collected, and knows from `seq` whether a
// row still holds the sequence it expects (rows are reused after
// TRACE_ROWS sequences).  Marks on one stream run in stream order, so the
// marks of a sequence all read the count that its last mark bumps.  What
// bounds a mark: one kernel node, ~1 us of a graph's replay.
//
// eppm_graph_nodes counts a graph's nodes by type, and by the marks that
// precede them: every node is put after the latest mark among its
// ancestors (the marks of a sequence form one chain, so that is one mark).

#include <cuda_runtime.h>

#include <unordered_map>
#include <vector>

#define TRACE_ROWS 64
#define TRACE_SLOTS 256

__device__ unsigned long long eppm_trace_ring[TRACE_ROWS][TRACE_SLOTS];
__device__ unsigned long long eppm_trace_seq[TRACE_ROWS];
__device__ unsigned long long eppm_trace_count;
__device__ unsigned long long eppm_trace_anchor_ns;

__device__ __forceinline__ unsigned long long global_ns()
{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void trace_mark_kernel(int slot, int last)
{
    const unsigned long long k =
        *(volatile unsigned long long*)&eppm_trace_count;
    const int row = (int)(k % TRACE_ROWS);
    eppm_trace_ring[row][slot] = global_ns();
    if (last) {
        eppm_trace_seq[row] = k;
        eppm_trace_count = k + 1;
    }
}

__global__ void trace_anchor_kernel() { eppm_trace_anchor_ns = global_ns(); }

extern "C" int eppm_trace_geometry(int* rows, int* slots)
{
    *rows = TRACE_ROWS;
    *slots = TRACE_SLOTS;
    return 0;
}

extern "C" int eppm_trace_mark(int slot, int last, void* stream)
{
    if (slot < 0 || slot >= TRACE_SLOTS) return (int)cudaErrorInvalidValue;
    trace_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(slot, last);
    return (int)cudaGetLastError();
}

extern "C" int eppm_trace_anchor(void* stream)
{
    trace_anchor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// Zeroes the count of finished sequences of the current device (blocking).
extern "C" int eppm_trace_reset(void)
{
    const unsigned long long zero = 0;
    return (int)cudaMemcpyToSymbol(eppm_trace_count, &zero, sizeof zero);
}

// Copies the ring (TRACE_ROWS x TRACE_SLOTS), the rows' sequence numbers,
// the count and the last anchor of the current device to the host
// (blocking).
extern "C" int eppm_trace_read(unsigned long long* ring,
                               unsigned long long* seq,
                               unsigned long long* count,
                               unsigned long long* anchor)
{
    cudaError_t e = cudaMemcpyFromSymbol(ring, eppm_trace_ring,
                                         sizeof eppm_trace_ring);
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(seq, eppm_trace_seq, sizeof eppm_trace_seq);
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(count, eppm_trace_count, sizeof *count);
    if (e == cudaSuccess)
        e = cudaMemcpyFromSymbol(anchor, eppm_trace_anchor_ns,
                                 sizeof *anchor);
    return (int)e;
}

#if CUDART_VERSION >= 13000
#define EPPM_GRAPH_EDGES(g, from, to, n) \
    cudaGraphGetEdges(g, from, to, nullptr, n)
#else
#define EPPM_GRAPH_EDGES(g, from, to, n) cudaGraphGetEdges(g, from, to, n)
#endif

enum { NODE_KERNEL, NODE_MEMCPY, NODE_MEMSET, NODE_OTHER, NODE_MARK,
       NODE_TYPES };

// counts: (rows x NODE_TYPES) ints, zeroed by the caller.  Row 0 counts the
// nodes that no mark precedes, row m + 1 those whose latest preceding mark
// is the graph's m-th (mark m itself in its column NODE_MARK).  *marks
// receives the number of marks found; marks past row rows - 1 fall in it.
extern "C" int eppm_graph_nodes(void* graph, int rows, int* counts,
                                int* marks)
{
    cudaGraph_t g = (cudaGraph_t)graph;
    size_t n = 0, ne = 0;
    cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
    if (e != cudaSuccess) return (int)e;
    std::vector<cudaGraphNode_t> nodes(n);
    if (n && (e = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess)
        return (int)e;
    if ((e = EPPM_GRAPH_EDGES(g, nullptr, nullptr, &ne)) != cudaSuccess)
        return (int)e;
    std::vector<cudaGraphNode_t> from(ne), to(ne);
    if (ne && (e = EPPM_GRAPH_EDGES(g, from.data(), to.data(), &ne))
                    != cudaSuccess)
        return (int)e;
    std::unordered_map<cudaGraphNode_t, size_t> index;
    for (size_t i = 0; i < n; ++i) index[nodes[i]] = i;
    std::vector<std::vector<size_t>> out(n);
    std::vector<int> indegree(n, 0);
    for (size_t i = 0; i < ne; ++i) {
        const size_t a = index.at(from[i]), b = index.at(to[i]);
        out[a].push_back(b);
        ++indegree[b];
    }
    // Kahn's order; row[i]: the row of node i, the latest mark before it
    std::vector<int> row(n, 0);
    std::vector<size_t> ready;
    for (size_t i = 0; i < n; ++i)
        if (!indegree[i]) ready.push_back(i);
    int found = 0;
    while (!ready.empty()) {
        const size_t i = ready.back();
        ready.pop_back();
        cudaGraphNodeType type;
        if ((e = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess)
            return (int)e;
        int col = NODE_OTHER;
        if (type == cudaGraphNodeTypeKernel) {
            col = NODE_KERNEL;
            cudaKernelNodeParams p;
            if (cudaGraphKernelNodeGetParams(nodes[i], &p) == cudaSuccess) {
                if (p.func == (void*)trace_mark_kernel) {
                    col = NODE_MARK;
                    ++found;
                    row[i] = found < rows ? found : rows - 1;
                }
            } else {
                cudaGetLastError();  // a kernel the runtime cannot name
            }
        } else if (type == cudaGraphNodeTypeMemcpy) {
            col = NODE_MEMCPY;
        } else if (type == cudaGraphNodeTypeMemset) {
            col = NODE_MEMSET;
        }
        ++counts[row[i] * NODE_TYPES + col];
        for (size_t j : out[i]) {
            if (row[i] > row[j]) row[j] = row[i];
            if (!--indegree[j]) ready.push_back(j);
        }
    }
    *marks = found;
    return 0;
}
