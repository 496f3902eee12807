"""A tensor that reports a device with neither a kernel nor a meta path,
for the kernel wrappers' refusal tests (test_torch_rma_kernels,
test_torch_ring_attention, test_torch_ssd)."""
import torch


class _Elsewhere(torch.Tensor):
    """A meta tensor whose `device` says "xpu"."""

    @property
    def device(self):
        return torch.device("xpu")


def elsewhere(x):
    """`x` as a meta tensor on "another device"."""
    return torch.Tensor._make_subclass(_Elsewhere, x.to("meta"))
