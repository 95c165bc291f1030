"""Wrap ``torch.nn.Module`` networks as model factors.

Counterpart of ``mxfusion_tpu/components/functions/flax_function.py``
(``FlaxFunction``): every parameter of the wrapped network is lifted
into an ``isInherited`` Variable, so that priors can be placed over the
weights (Bayesian NNs). At evaluation the parameter values come from the
runtime env through ``torch.func.functional_call``, so the network's own
tensors are never read or written and gradients flow back into the
env's values. Buffers, the counterpart of flax's non-``params``
collections, ride along read-only.

Names: the parameter at path ``Dense_0.kernel`` of a network wrapped as
``f`` is ``f_Dense_0_kernel``, the name flax gives it. A network whose
sub-modules are ``Dense_0``, ``Dense_1``, ... with ``kernel`` (in, out)
and ``bias`` parameters therefore lines up one to one with a flax
network of Dense layers (persistence and carryover match by these
names); ``util.carryover.linear_stack_map`` maps a stack of
``nn.Linear`` layers onto such names.
"""
import torch

from .function import Function
from ..variables.variable import Variable
from ...common.config import as_torch_dtype, resolve_device
from ...common.exceptions import ModelSpecificationError


class NNFunction(Function):
    """A ``torch.nn.Module`` lifted into the model IR.

    Parameters
    ----------
    module : torch.nn.Module
        The network, already built; its current parameter values are
        the lifted Variables' initial values (seed its initialization
        with ``torch.manual_seed``).
    name : str
        Prefix for the generated input, output and parameter names.
    input_shapes : list of tuple
        Example shapes (without the sample axis) of the inputs: one trial
        call on zeros of these shapes checks that the module leaves its
        buffers alone.
    num_outputs : int
    broadcastable : bool
        If True the module is applied once with the sample axis riding
        along the batch dims; forced off when any parameter is a random
        variable (per-sample weights are mapped with ``torch.func.vmap``).
    dtype, device :
        The dtype and device of the trial call and of the buffers
        (default: the package's defaults, the card unless the CPU is
        asked for).
    """

    def __init__(self, module, name, input_shapes, num_outputs=1,
                 broadcastable=False, dtype=None, device=None):
        self.module = module
        dtype = as_torch_dtype(dtype)
        device = resolve_device(device)
        self._param_paths = []   # (lifted name, path in the module)
        parameters = {}
        for path, p in module.named_parameters():
            pname = name + "_" + path.replace(".", "_")
            v = Variable(shape=tuple(p.shape),
                         initial_value=p.detach().cpu().numpy())
            v.isInherited = True
            parameters[pname] = v
            self._param_paths.append((pname, path))
        self._buffers = {
            path: b.detach().to(
                device=device, dtype=dtype if b.is_floating_point()
                else b.dtype)
            for path, b in module.named_buffers()}
        self._buffers_by_place = {(device, dtype): self._buffers}
        input_names = [name + "_input_" + str(i)
                       for i in range(len(input_shapes))]
        output_names = [name + "_output_" + str(i)
                        for i in range(num_outputs)]
        super().__init__(
            func=None, input_names=input_names, output_names=output_names,
            parameters=parameters, broadcastable=broadcastable, name=name)
        self._check_buffers_unchanged(input_shapes, dtype, device)

    def _check_buffers_unchanged(self, input_shapes, dtype, device):
        """One call on zeros of ``input_shapes`` with copies of the
        buffers: a buffer whose version counter moved was written in
        place (e.g. ``BatchNorm1d``'s running statistics in train
        mode), which the graph cannot carry."""
        if not self._buffers:
            return
        tensors = {path: torch.as_tensor(
            self._parameters[pname].initial_value, dtype=dtype,
            device=device) for pname, path in self._param_paths}
        buffers = {path: b.clone() for path, b in self._buffers.items()}
        versions = {path: b._version for path, b in buffers.items()}
        examples = tuple(torch.zeros(s, dtype=dtype, device=device)
                         for s in input_shapes)
        with torch.no_grad():
            torch.func.functional_call(self.module, {**tensors, **buffers},
                                       examples)
        mutated = sorted(path for path, b in buffers.items()
                         if b._version != versions[path])
        if mutated:
            raise ModelSpecificationError(
                "NNFunction('{}') cannot wrap this module: applying it "
                "writes its buffers {} in place. Modules that mutate a "
                "buffer when applied (e.g. BatchNorm in train mode) are "
                "not supported inside the model graph: put the module in "
                "eval mode or manage that state outside the model.".format(
                    self.name, mutated))

    def _buffers_at(self, like):
        """The buffers on ``like``'s device, floating ones in its dtype."""
        place = (like.device, like.dtype)
        if place not in self._buffers_by_place:
            self._buffers_by_place[place] = {
                path: b.to(device=like.device,
                           dtype=like.dtype if b.is_floating_point()
                           else b.dtype)
                for path, b in self._buffers.items()}
        return self._buffers_by_place[place]

    def eval(self, params, **data):
        args = tuple(data[n] for n in self.input_names)
        tensors = {path: params[pname] for pname, path in self._param_paths}
        if self._buffers:
            tensors.update(self._buffers_at(args[0]))
        out = torch.func.functional_call(self.module, tensors, args)
        n_out = len(out) if isinstance(out, (list, tuple)) else 1
        if n_out != len(self.output_names):
            raise ModelSpecificationError(
                "NNFunction('{}') returned {} output(s) but was declared "
                "with num_outputs={}: outputs would be silently dropped or "
                "missing.".format(self.name, n_out, len(self.output_names)))
        return out

