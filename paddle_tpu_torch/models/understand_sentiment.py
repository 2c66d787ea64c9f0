"""Book chapter 06: understand_sentiment (IMDB).

Parity: python/paddle/fluid/tests/book/test_understand_sentiment.py and
the JAX package's models/understand_sentiment.py, unchanged in content —
conv net (sequence_conv_pool) and stacked bi-LSTM bodies. The conv net's
SQRT pools run the masked-pool kernel; the stacked LSTM keeps
dynamic_lstm's default peepholes, so it runs the torch loop (a no-peephole
build, which runs the fused-LSTM kernel, passes use_peepholes=False to the
same layer calls).
"""
import paddle_tpu_torch as fluid


def convolution_net(data, dict_dim, class_dim=2, emb_dim=32, hid_dim=32):
    emb = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim])
    conv_3 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=3, act="tanh",
        pool_type="sqrt")
    conv_4 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=4, act="tanh",
        pool_type="sqrt")
    return fluid.layers.fc(input=[conv_3, conv_4], size=class_dim,
                           act="softmax")


def stacked_lstm_net(data, dict_dim, class_dim=2, emb_dim=128, hid_dim=512,
                     stacked_num=3):
    assert stacked_num % 2 == 1
    emb = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim])
    fc1 = fluid.layers.fc(input=emb, size=hid_dim)
    lstm1, cell1 = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim)
        lstm, cell = fluid.layers.dynamic_lstm(
            input=fc, size=hid_dim, is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = fluid.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = fluid.layers.sequence_pool(input=inputs[1], pool_type="max")
    return fluid.layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")


def build(net="lstm", dict_dim=1000, class_dim=2, learning_rate=0.002,
          emb_dim=32, hid_dim=32):
    data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    if net == "conv":
        prediction = convolution_net(data, dict_dim, class_dim, emb_dim,
                                     hid_dim)
    else:
        prediction = stacked_lstm_net(data, dict_dim, class_dim, emb_dim,
                                      hid_dim, stacked_num=3)
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(x=cost)
    acc = fluid.layers.accuracy(input=prediction, label=label)
    fluid.optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    return data, label, avg_cost, acc
