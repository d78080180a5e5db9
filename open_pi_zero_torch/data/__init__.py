"""The data layer (counterpart of the JAX package's ``data/``), without
TensorFlow: TFRecord files and the ``tf.train.Example`` wire format
(``tfrecord``, ``tf_example``), a PNG codec (``images``) and the port's own
JPEG codec (``jpeg``), RLDS episodes (``rlds``) and their offline resize
(``preprocess``), statistics and normalization, the OXE transforms and
mixes (``oxe``, ``oxe_registry``), trajectory and frame transforms, and
the weighted interleave (``pipeline``), in numpy, threads and host C++.
The tokenizer's text processing waits in ROADMAP.md queue 1."""
