// Stitches CUDA graphs that PyTorch captured into one executable graph,
// with device-side loops: the counterpart of a jitted XLA program whose
// ``lax.while_loop`` ends on the device (sdpl_slam_tpu/models/resident.py,
// ``jit_resident_step``; the joint LM's loop in
// sdpl_slam_tpu/solvers/frame_solvers.py).
//
// Glue, not the port of a TPU kernel.  PyTorch (2.11) can capture a
// conditional IF node but no WHILE node, so the loops are built here with
// CUDA's graph API (12.4+): a sequence of items, each either
//
//   a segment:  a child-graph node holding a captured graph, or
//   a loop:     set(flag) -> WHILE { child(body) -> set(flag) },
//
// where ``flag`` is a device bool that the body itself updates and
// ``set`` is a one-thread kernel that copies it into the loop's
// conditional handle.  The items run in order; the whole is instantiated
// once and launched on PyTorch's current stream, so a frame is one graph
// launch and the host never reads the device to end a loop.
//
// Plain C entry points (bound with ctypes); every call returns the
// cudaError_t it met, 0 on success.

#include <cuda_runtime.h>

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

static cudaError_t add_while(cudaGraphNode_t* node, cudaGraph_t graph,
                             const cudaGraphNode_t* deps, size_t n_deps,
                             cudaGraph_t body, const unsigned char* flag) {
    cudaGraphConditionalHandle handle;
    cudaError_t e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (e != cudaSuccess) return e;
    cudaGraphNode_t set0;
    e = add_set(&set0, graph, deps, n_deps, handle, flag);
    if (e != cudaSuccess) return e;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(node, graph, &set0, nullptr, 1, &cp);
#else
    e = cudaGraphAddNode(node, graph, &set0, 1, &cp);
#endif
    if (e != cudaSuccess) return e;
    cudaGraph_t inner = cp.conditional.phGraph_out[0];
    cudaGraphNode_t child, set1;
    e = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0, body);
    if (e != cudaSuccess) return e;
    return add_set(&set1, inner, &child, 1, handle, flag);
}

extern "C" {

// Build and instantiate the graph of ``n`` items: kinds[i] 0 = segment
// graphs[i]; 1 = loop with body graphs[i] and condition flags[i].  The
// graphs are cloned into the new one (the caller keeps its own).
int sdpl_graph_build(int n, const int* kinds, void* const* graphs,
                     void* const* flags, void** graph_out, void** exec_out) {
    cudaGraph_t g;
    cudaError_t e = cudaGraphCreate(&g, 0);
    if (e != cudaSuccess) return (int)e;
    cudaGraphNode_t prev = nullptr;
    for (int i = 0; i < n && e == cudaSuccess; ++i) {
        cudaGraphNode_t node;
        size_t n_deps = prev ? 1 : 0;
        if (kinds[i] == 0) {
            e = cudaGraphAddChildGraphNode(&node, g, &prev, n_deps,
                                           (cudaGraph_t)graphs[i]);
        } else {
            e = add_while(&node, g, &prev, n_deps, (cudaGraph_t)graphs[i],
                          (const unsigned char*)flags[i]);
        }
        prev = node;
    }
    cudaGraphExec_t exec = nullptr;
    if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, g, 0);
    if (e != cudaSuccess) {
        cudaGraphDestroy(g);
        return (int)e;
    }
    *graph_out = (void*)g;
    *exec_out = (void*)exec;
    return 0;
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
