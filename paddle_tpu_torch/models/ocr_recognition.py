"""OCR recognition with CTC (CRNN).

Parity: the fluid benchmark's ocr_recognition/crnn_ctc_model and the JAX
package's models/ocr_recognition.py, the same layer calls and parameter
names: conv-bn-pool groups, im2sequence slicing the feature map into
columns, a bidirectional GRU with a relu candidate (the torch loop of the
`gru` rule: no kernel of the port takes a relu candidate, and the JAX
package has no Pallas GRU), per-column class logits, warpctc. Evaluation
decodes with ctc_greedy_decoder and scores with edit_distance.
"""
import paddle_tpu_torch as fluid


def conv_bn_pool(input, group, out_ch, act="relu", is_test=False,
                 pool_stride=2):
    tmp = input
    for i in range(group):
        tmp = fluid.layers.conv2d(
            input=tmp, num_filters=out_ch, filter_size=3, padding=1,
            bias_attr=False)
        tmp = fluid.layers.batch_norm(input=tmp, act=act, is_test=is_test)
    return fluid.layers.pool2d(
        input=tmp, pool_size=2, pool_type="max", pool_stride=pool_stride)


def ocr_convs(input, is_test=False, channels=(16, 32, 64)):
    tmp = input
    for ch in channels:
        tmp = conv_bn_pool(tmp, 2, ch, is_test=is_test)
    return tmp


def encoder_net(images, num_classes, rnn_hidden_size=64, is_test=False,
                channels=(16, 32, 64)):
    """Images [B, 1, H, W] -> per-column logits sequence [B, W', C+1]."""
    conv_features = ocr_convs(images, is_test=is_test, channels=channels)
    # one step per column of the feature map: its full height x channels
    h = conv_features.shape[2]
    sliced_feature = fluid.layers.im2sequence(
        input=conv_features, filter_size=(h, 1), stride=(1, 1))

    fc_1 = fluid.layers.fc(input=sliced_feature, size=rnn_hidden_size * 3)
    fc_2 = fluid.layers.fc(input=sliced_feature, size=rnn_hidden_size * 3)
    gru_forward = fluid.layers.dynamic_gru(
        input=fc_1, size=rnn_hidden_size, candidate_activation="relu")
    gru_backward = fluid.layers.dynamic_gru(
        input=fc_2, size=rnn_hidden_size, is_reverse=True,
        candidate_activation="relu")

    return fluid.layers.fc(input=[gru_forward, gru_backward],
                           size=num_classes + 1)


def ctc_train_net(images, label, num_classes, learning_rate=1e-3,
                  rnn_hidden_size=64, channels=(16, 32, 64)):
    """Returns (sum_cost, decoded, edit_distance_out, seq_num)."""
    fc_out = encoder_net(images, num_classes,
                         rnn_hidden_size=rnn_hidden_size, channels=channels)
    cost = fluid.layers.warpctc(
        input=fc_out, label=label, blank=num_classes, norm_by_times=True)
    sum_cost = fluid.layers.reduce_sum(cost)
    optimizer = fluid.optimizer.Momentum(
        learning_rate=learning_rate, momentum=0.9)
    optimizer.minimize(sum_cost)

    decoded_out = fluid.layers.ctc_greedy_decoder(
        input=fc_out, blank=num_classes)
    error, seq_num = fluid.layers.edit_distance(
        input=decoded_out, label=label, normalized=True)
    return sum_cost, decoded_out, error, seq_num
