// Stitches CUDA graphs that PyTorch captured into one executable graph,
// with device-side loops: the counterpart of a jitted XLA program whose
// ``lax.while_loop`` ends on the device (sdpl_slam_tpu/models/resident.py,
// ``jit_resident_step``; the joint LM's loop in
// sdpl_slam_tpu/solvers/frame_solvers.py; the BA's LM loop and the CG
// loop nested in it, sdpl_slam_tpu/solvers/batch_ba.py ``run_ba_fused``).
//
// Glue, not the port of a TPU kernel.  PyTorch (2.11) can capture a
// conditional IF node but no WHILE node, so the loops are built here with
// CUDA's graph API (12.4+, which also allows a conditional node inside the
// body of another): a sequence of items, each either
//
//   a segment:  a child-graph node holding a captured graph, or
//   a loop:     set(flag) -> WHILE { body -> set(flag) },
//
// where the body is itself a sequence of segments and loops, ``flag`` is a
// device bool that the body updates and ``set`` is a one-thread kernel
// that copies it into the loop's conditional handle.  The items run in
// order; the whole is instantiated once and launched on PyTorch's current
// stream, so the host never reads the device to end a loop.
//
// The sequence comes flattened, in order: kind 0 = segment ``graphs[i]``,
// 1 = a loop on ``flags[i]`` opens (its body items follow), 2 = the
// innermost open loop closes.
//
// Plain C entry points (bound with ctypes); every call returns the
// cudaError_t it met, 0 on success.

#include <cuda_runtime.h>

// The step of the last sdpl_graph_build that failed, for the error message.
static const char* g_where = "";
#define STEP(what, call) (g_where = (what), (call))

__global__ void sdpl_set_condition(cudaGraphConditionalHandle handle,
                                   const unsigned char* flag) {
    cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

static cudaError_t add_set(cudaGraphNode_t* node, cudaGraph_t graph,
                           const cudaGraphNode_t* deps, size_t n_deps,
                           cudaGraphConditionalHandle handle,
                           const unsigned char* flag) {
    cudaKernelNodeParams p = {};
    void* args[2] = {&handle, &flag};
    p.func = (void*)sdpl_set_condition;
    p.gridDim = dim3(1, 1, 1);
    p.blockDim = dim3(1, 1, 1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    p.extra = nullptr;
    return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

struct Items {
    int n;
    const int* kinds;
    void* const* graphs;
    void* const* flags;
    int pos;                 // next item to read
};

static cudaError_t add_while(cudaGraphNode_t* node, cudaGraph_t graph,
                             const cudaGraphNode_t* deps, size_t n_deps,
                             const unsigned char* flag, Items* it);

// Appends the items from ``it->pos`` up to the close of the loop being
// built (or the end) to ``graph`` as a chain after ``prev``; the chain's
// last node goes to ``*last`` (``prev`` when there was no item).
static cudaError_t add_items(cudaGraph_t graph, cudaGraphNode_t prev,
                             Items* it, cudaGraphNode_t* last) {
    cudaError_t e = cudaSuccess;
    while (it->pos < it->n && e == cudaSuccess) {
        int i = it->pos++;
        if (it->kinds[i] == 2) break;
        cudaGraphNode_t node;
        size_t n_deps = prev ? 1 : 0;
        if (it->kinds[i] == 0) {
            e = STEP("adding a segment",
                     cudaGraphAddChildGraphNode(&node, graph, &prev, n_deps,
                                                (cudaGraph_t)it->graphs[i]));
        } else {
            e = add_while(&node, graph, &prev, n_deps,
                          (const unsigned char*)it->flags[i], it);
        }
        prev = node;
    }
    *last = prev;
    return e;
}

static cudaError_t add_while(cudaGraphNode_t* node, cudaGraph_t graph,
                             const cudaGraphNode_t* deps, size_t n_deps,
                             const unsigned char* flag, Items* it) {
    cudaGraphConditionalHandle handle;
    cudaError_t e = STEP("cudaGraphConditionalHandleCreate",
                         cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                                          0));
    if (e != cudaSuccess) return e;
    cudaGraphNode_t set0;
    e = STEP("adding a condition kernel",
             add_set(&set0, graph, deps, n_deps, handle, flag));
    if (e != cudaSuccess) return e;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    g_where = "adding a WHILE node";
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(node, graph, &set0, nullptr, 1, &cp);
#else
    e = cudaGraphAddNode(node, graph, &set0, 1, &cp);
#endif
    if (e != cudaSuccess) return e;
    cudaGraph_t body = cp.conditional.phGraph_out[0];
    cudaGraphNode_t last, set1;
    e = add_items(body, nullptr, it, &last);
    if (e != cudaSuccess) return e;
    return STEP("adding a condition kernel",
                add_set(&set1, body, &last, last ? 1 : 0, handle, flag));
}

extern "C" {

// Build and instantiate the graph of the ``n`` flattened items (see the
// top of this file).  The graphs are cloned into the new one (the caller
// keeps its own).
int sdpl_graph_build(int n, const int* kinds, void* const* graphs,
                     void* const* flags, void** graph_out, void** exec_out) {
    cudaGraph_t g;
    cudaError_t e = STEP("cudaGraphCreate", cudaGraphCreate(&g, 0));
    if (e != cudaSuccess) return (int)e;
    Items it = {n, kinds, graphs, flags, 0};
    cudaGraphNode_t last;
    e = add_items(g, nullptr, &it, &last);
    if (e == cudaSuccess && it.pos != n)
        e = STEP("reading the items", cudaErrorInvalidValue);
    cudaGraphExec_t exec = nullptr;
    if (e == cudaSuccess)
        e = STEP("cudaGraphInstantiate", cudaGraphInstantiate(&exec, g, 0));
    if (e != cudaSuccess) {
        cudaGraphDestroy(g);
        return (int)e;
    }
    *graph_out = (void*)g;
    *exec_out = (void*)exec;
    return 0;
}

const char* sdpl_graph_build_where() { return g_where; }

// The number of nodes of a captured graph (its top level).
int sdpl_graph_node_count(void* graph, size_t* n_out) {
    return (int)cudaGraphGetNodes((cudaGraph_t)graph, nullptr, n_out);
}

// Adds the graph's nodes by type (cudaGraphNodeType, child graphs walked
// into) to counts[0..n_types).
int sdpl_graph_node_types(void* graph, int* counts, int n_types) {
    size_t n = 0;
    cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
    if (e != cudaSuccess || n == 0) return (int)e;
    cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
    e = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &n);
    for (size_t i = 0; i < n && e == cudaSuccess; ++i) {
        cudaGraphNodeType t;
        e = cudaGraphNodeGetType(nodes[i], &t);
        if (e != cudaSuccess) break;
        if ((int)t < n_types) counts[(int)t] += 1;
        if (t == cudaGraphNodeTypeGraph) {
            cudaGraph_t child;
            e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
            if (e == cudaSuccess)
                e = (cudaError_t)sdpl_graph_node_types(child, counts, n_types);
        }
    }
    delete[] nodes;
    return (int)e;
}

int sdpl_graph_launch(void* exec, void* stream) {
    cudaError_t e = cudaGraphLaunch((cudaGraphExec_t)exec,
                                    (cudaStream_t)stream);
    if (e == cudaSuccess) e = cudaGetLastError();
    return (int)e;
}

int sdpl_graph_destroy(void* graph, void* exec) {
    cudaError_t e = cudaSuccess;
    if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
    if (graph) {
        cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
        if (e == cudaSuccess) e = e2;
    }
    return (int)e;
}

const char* sdpl_graph_error_string(int e) {
    return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
