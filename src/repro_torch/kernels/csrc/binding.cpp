// PyTorch binding for the port's CUDA kernels: the only source that
// includes torch/extension.h.  Each function takes tensors the Python
// wrapper has already checked (device, dtype, shape, contiguity), fills
// the plain-C argument structs, launches on the current stream and
// raises on a refused launch.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <pybind11/stl.h>

#include <vector>

#include "rt_types.h"

namespace {

FlowArgs flow_args(at::Tensor& keys, at::Tensor& regs,
                   const at::Tensor& pkt_keys, const at::Tensor& upd,
                   const at::Tensor& bins, const at::Tensor& valid,
                   const at::Tensor& order, const at::Tensor& seg_first,
                   const at::Tensor& seg_len, const at::Tensor& seg_slot,
                   int64_t n_counters, int64_t n_ewma, double alpha) {
  TORCH_CHECK(regs.size(1) <= 32 * RT_COLS, "register width > ",
              32 * RT_COLS);
  FlowArgs a;
  a.keys = keys.data_ptr<int>();
  a.regs = regs.data_ptr<float>();
  a.pkt_keys = pkt_keys.data_ptr<int>();
  a.upd = upd.data_ptr<float>();
  a.bins = bins.data_ptr<int>();
  a.valid = valid.data_ptr<int>();
  a.order = order.data_ptr<int>();
  a.seg_first = seg_first.data_ptr<int>();
  a.seg_len = seg_len.data_ptr<int>();
  a.seg_slot = seg_slot.data_ptr<int>();
  a.B = (int)pkt_keys.size(0);
  a.W = (int)regs.size(1);
  a.U = (int)upd.size(1);
  a.H = (int)bins.size(1);
  a.C = (int)n_counters;
  a.E = (int)n_ewma;
  a.alpha = (float)alpha;
  return a;
}

MlpDims mlp_dims(const std::vector<int64_t>& widths) {
  TORCH_CHECK(widths.size() >= 2 && widths.size() <= RT_MAX_LAYERS + 1,
              "MLP needs 1..", RT_MAX_LAYERS, " layers");
  MlpDims d;
  d.n_layers = (int)widths.size() - 1;
  d.n_w = 0;
  d.n_b = 0;
  for (size_t i = 0; i < widths.size(); ++i) {
    TORCH_CHECK(widths[i] >= 1 && widths[i] <= RT_MAX_MLP_WIDTH,
                "MLP width out of range: ", widths[i]);
    d.widths[i] = (int)widths[i];
    if (i > 0) {
      d.n_w += d.widths[i - 1] * d.widths[i];
      d.n_b += d.widths[i];
    }
  }
  return d;
}

cudaStream_t stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void flow_update(at::Tensor keys, at::Tensor regs, at::Tensor pkt_keys,
                 at::Tensor upd, at::Tensor bins, at::Tensor valid,
                 at::Tensor order, at::Tensor seg_first, at::Tensor seg_len,
                 at::Tensor seg_slot, at::Tensor feats, int64_t n_counters,
                 int64_t n_ewma, double alpha) {
  c10::cuda::CUDAGuard guard(regs.device());
  FlowArgs a = flow_args(keys, regs, pkt_keys, upd, bins, valid, order,
                         seg_first, seg_len, seg_slot, n_counters, n_ewma,
                         alpha);
  C10_CUDA_CHECK(launch_flow_update(a, feats.data_ptr<float>(),
                                    stream_of(regs)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_mlp_classify(at::Tensor x, at::Tensor w_flat, at::Tensor b_flat,
                        std::vector<int64_t> widths, at::Tensor out) {
  c10::cuda::CUDAGuard guard(x.device());
  MlpDims d = mlp_dims(widths);
  TORCH_CHECK(w_flat.numel() == d.n_w && b_flat.numel() == d.n_b,
              "packed MLP does not match its widths");
  C10_CUDA_CHECK(launch_fused_mlp_classify(
      x.data_ptr<float>(), (int)x.size(0), d, w_flat.data_ptr<float>(),
      b_flat.data_ptr<float>(), out.data_ptr<int>(), stream_of(x)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fused_flow_serve(at::Tensor keys, at::Tensor regs, at::Tensor pkt_keys,
                      at::Tensor upd, at::Tensor bins, at::Tensor valid,
                      at::Tensor order, at::Tensor seg_first,
                      at::Tensor seg_len, at::Tensor seg_slot,
                      at::Tensor w_flat, at::Tensor b_flat,
                      std::vector<int64_t> widths, at::Tensor verdicts,
                      int64_t n_counters, int64_t n_ewma, double alpha,
                      int64_t mode) {
  c10::cuda::CUDAGuard guard(regs.device());
  FlowArgs a = flow_args(keys, regs, pkt_keys, upd, bins, valid, order,
                         seg_first, seg_len, seg_slot, n_counters, n_ewma,
                         alpha);
  MlpDims d = mlp_dims(widths);
  TORCH_CHECK(w_flat.numel() == d.n_w && b_flat.numel() == d.n_b,
              "packed MLP does not match its widths");
  TORCH_CHECK(mode >= 0 && mode <= 2, "readout mode must be 0, 1 or 2");
  C10_CUDA_CHECK(launch_fused_flow_serve(
      a, d, w_flat.data_ptr<float>(), b_flat.data_ptr<float>(),
      verdicts.data_ptr<int>(), (int)mode, stream_of(regs)));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flow_update", &flow_update, "K2: flow-register update");
  m.def("fused_mlp_classify", &fused_mlp_classify, "K3: MLP + argmax");
  m.def("fused_flow_serve", &fused_flow_serve,
        "K1: register update + readout + MLP + argmax");
}
