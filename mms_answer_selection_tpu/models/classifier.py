"""Image classifier application wrapper (python/caffe/classifier.py).

``Classifier`` extends the pycaffe-style :class:`~.pynet.Net` for image
class prediction by scaling, center-cropping, or oversampling — the
reference's demo application surface (classify.py drives it).

Layout note: the reference preprocesses to caffe's NCHW; this
framework's nets run NHWC (XLA's natural convolution layout).  The
:class:`~..utils.io.Transformer` here is configured EXACTLY like the
reference's (transpose to CHW, channel swap, raw scale, mean, input
scale — so mean files and preprocessing recipes port unchanged), and the
batch is permuted NCHW->NHWC once at the net boundary.
"""

from __future__ import annotations

import numpy as np

from ..utils import io as caffe_io
from .pynet import Net

__all__ = ["Classifier"]


class Classifier(Net):
    """``Classifier(deploy_prototxt, weights, mean=..., raw_scale=255,
    channel_swap=(2, 1, 0))`` (classifier.py:11-45).

    The deploy prototxt must declare its input shape
    (``input_shape``/``input_dim`` or an Input layer) — that is what
    fixes ``crop_dims``, exactly as ``self.blobs[in_].data.shape`` does
    in the reference.

    ``image_dims``: dimensions to scale inputs to before
    cropping/sampling; defaults to the net input size (whole-image
    crop).
    """

    def __init__(self, model_file: str, pretrained_file: str | None = None,
                 image_dims=None, mean=None, input_scale=None,
                 raw_scale=None, channel_swap=None):
        super().__init__(model_file, phase="test", weights=pretrained_file)
        shapes = self._net.declared_input_shapes(nhwc=False)
        in_ = self.inputs[0]
        if in_ not in shapes or len(shapes[in_]) != 4:
            raise ValueError(
                f"deploy net must declare a 4-D shape for input {in_!r} "
                "(input_shape / input_dim / Input layer shape)")
        self.transformer = caffe_io.Transformer({in_: shapes[in_]})
        self.transformer.set_transpose(in_, (2, 0, 1))
        if mean is not None:
            self.transformer.set_mean(in_, mean)
        if input_scale is not None:
            self.transformer.set_input_scale(in_, input_scale)
        if raw_scale is not None:
            self.transformer.set_raw_scale(in_, raw_scale)
        if channel_swap is not None:
            self.transformer.set_channel_swap(in_, channel_swap)

        self.crop_dims = np.array(shapes[in_][2:])
        self.image_dims = np.array(image_dims if image_dims is not None
                                   else self.crop_dims)

    def predict(self, inputs, oversample: bool = True):
        """(H, W, K) image iterable -> (N, C) class probabilities;
        averaged over 10 crops when ``oversample`` (classifier.py:47-99).
        """
        input_ = np.zeros((len(inputs), self.image_dims[0],
                           self.image_dims[1], inputs[0].shape[2]),
                          np.float32)
        for ix, im in enumerate(inputs):
            input_[ix] = caffe_io.resize_image(im, self.image_dims)

        if oversample:
            input_ = caffe_io.oversample(input_, self.crop_dims)
        else:
            center = np.array(self.image_dims) / 2.0
            crop = (np.tile(center, 2) + np.concatenate(
                [-self.crop_dims / 2.0,
                 self.crop_dims / 2.0])).astype(int)
            input_ = input_[:, crop[0]:crop[2], crop[1]:crop[3], :]

        in_ = self.inputs[0]
        caffe_in = np.zeros(np.array(input_.shape)[[0, 3, 1, 2]],
                            np.float32)
        for ix, im in enumerate(input_):
            caffe_in[ix] = self.transformer.preprocess(in_, im)
        # net boundary: caffe NCHW -> this framework's NHWC
        out = self.forward_all(**{in_: caffe_in.transpose(0, 2, 3, 1)})
        predictions = np.asarray(out[self.outputs[0]])

        if oversample:
            predictions = predictions.reshape(
                (len(predictions) // 10, 10, -1)).mean(1)
        return predictions
