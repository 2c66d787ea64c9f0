"""Book chapter 04: word2vec N-gram language model (imikolov).

Parity: python/paddle/fluid/tests/book/test_word2vec.py and the JAX
package's models/word2vec.py: 4-word context, shared embedding, concat →
hidden fc → softmax, cross_entropy on the probabilities (not the fused
softmax_with_cross_entropy), SGD.
"""
import paddle_tpu_torch as fluid


def build(dict_size=1000, embed_size=32, hidden_size=256, is_sparse=False,
          learning_rate=0.001):
    words = []
    for name in ("firstw", "secondw", "thirdw", "forthw", "nextw"):
        words.append(fluid.layers.data(name=name, shape=[1], dtype="int64"))

    embs = []
    for w in words[:4]:
        embs.append(fluid.layers.embedding(
            input=w, size=[dict_size, embed_size],
            param_attr=fluid.ParamAttr(name="shared_w"), is_sparse=is_sparse))

    concat_embed = fluid.layers.concat(input=embs, axis=1)
    hidden1 = fluid.layers.fc(input=concat_embed, size=hidden_size,
                              act="sigmoid")
    predict_word = fluid.layers.fc(input=hidden1, size=dict_size,
                                   act="softmax")
    cost = fluid.layers.cross_entropy(input=predict_word, label=words[4])
    avg_cost = fluid.layers.mean(x=cost)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    return words, avg_cost
