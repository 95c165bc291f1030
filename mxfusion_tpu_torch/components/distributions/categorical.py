"""Categorical distribution.

Counterpart of ``mxfusion_tpu/components/distributions/categorical.py``.
Parameterized by unnormalized ``log_prob`` over ``axis``; takes one-hot
or index encodings (int64 indices for ``torch.gather``) and optional
log-softmax normalization. Draws by Gumbel-argmax on the generator.
"""
import torch
import torch.nn.functional as F

from .distribution import UnivariateDistribution
from ...common.config import as_torch_dtype


class Categorical(UnivariateDistribution):

    # discrete: no bijector, as the JAX package's (inherited) "real"
    support = "real"

    def __init__(self, log_prob, num_classes, one_hot_encoding=False,
                 normalization=True, axis=-1, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("log_prob", log_prob)], outputs=None,
            input_names=["log_prob"], output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)
        self.num_classes = num_classes
        self.one_hot_encoding = one_hot_encoding
        self.normalization = normalization
        self.axis = axis

    def _log_prob(self, log_prob):
        return F.log_softmax(log_prob, dim=self.axis) \
            if self.normalization else log_prob

    def log_pdf_impl(self, random_variable, log_prob):
        logp = self._log_prob(log_prob)
        if self.one_hot_encoding:
            return torch.sum(random_variable * logp, dim=self.axis)
        idx = random_variable.to(torch.int64)
        if idx.shape[-1] == 1:
            idx = idx[..., 0]
        idx = idx[..., None]
        # take_along_axis: the other axes broadcast, as in numpy
        a = self.axis % logp.ndim
        batch = list(torch.broadcast_shapes(
            logp.shape[:a] + (1,) + logp.shape[a + 1:],
            idx.shape[:a] + (1,) + idx.shape[a + 1:]))
        logp = logp.expand(batch[:a] + [logp.shape[a]] + batch[a + 1:])
        idx = idx.expand(batch[:a] + [idx.shape[a]] + batch[a + 1:])
        return torch.gather(logp, a, idx)[..., 0]

    def draw_samples_impl(self, rv_shape, num_samples, generator, log_prob):
        probs = torch.exp(self._log_prob(log_prob))
        probs = probs.expand((num_samples,) + tuple(probs.shape[1:]))
        idx = self._rand_gen.sample_multinomial(generator, probs)
        dtype = as_torch_dtype(self.dtype)
        if self.one_hot_encoding:
            return F.one_hot(idx, self.num_classes).to(dtype)
        out = idx.to(dtype)
        if len(rv_shape) > 0 and rv_shape[-1] == 1 and \
                out.ndim < 1 + len(rv_shape):
            out = out[..., None]
        return out

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica.num_classes = self.num_classes
        replica.one_hot_encoding = self.one_hot_encoding
        replica.normalization = self.normalization
        replica.axis = self.axis
        return replica

    @classmethod
    def define_variable(cls, log_prob, num_classes, shape=None,
                        one_hot_encoding=False, normalization=True, axis=-1,
                        rand_gen=None, dtype=None):
        dist = cls(log_prob=log_prob, num_classes=num_classes,
                   one_hot_encoding=one_hot_encoding,
                   normalization=normalization, axis=axis, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
