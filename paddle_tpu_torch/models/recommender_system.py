"""Book chapter 05: recommender_system (MovieLens).

Parity: python/paddle/fluid/tests/book/test_recommender_system.py and the
JAX package's models/recommender_system.py: twin feature towers (user
id/gender/age/job embeddings; movie id embedding + category sum-pool +
title conv-pool), cosine similarity scaled to the 5-star range,
squared-error cost. The two SUM sequence pools run the masked-pool kernel
(K9) on fp32. The tables take their sizes from the port's movielens
metadata (datasets/movielens.py).
"""
import paddle_tpu_torch as fluid
from paddle_tpu_torch import nets
from paddle_tpu_torch.datasets import movielens

IS_SPARSE = True

FEED_ORDER = ["user_id", "gender_id", "age_id", "job_id", "movie_id",
              "category_id", "movie_title", "score"]


def get_usr_combined_features(emb_dim=32, fc_dim=200):
    usr_dict_size = movielens.max_user_id() + 1
    uid = fluid.layers.data(name="user_id", shape=[1], dtype="int64")
    usr_emb = fluid.layers.embedding(
        input=uid, dtype="float32", size=[usr_dict_size, emb_dim],
        param_attr="user_table", is_sparse=IS_SPARSE)
    usr_fc = fluid.layers.fc(input=usr_emb, size=emb_dim)

    usr_gender_id = fluid.layers.data(name="gender_id", shape=[1],
                                      dtype="int64")
    usr_gender_emb = fluid.layers.embedding(
        input=usr_gender_id, size=[2, emb_dim // 2],
        param_attr="gender_table", is_sparse=IS_SPARSE)
    usr_gender_fc = fluid.layers.fc(input=usr_gender_emb, size=emb_dim // 2)

    age_size = len(movielens.age_table)
    usr_age_id = fluid.layers.data(name="age_id", shape=[1], dtype="int64")
    usr_age_emb = fluid.layers.embedding(
        input=usr_age_id, size=[age_size, emb_dim // 2],
        is_sparse=IS_SPARSE, param_attr="age_table")
    usr_age_fc = fluid.layers.fc(input=usr_age_emb, size=emb_dim // 2)

    job_size = movielens.max_job_id() + 1
    usr_job_id = fluid.layers.data(name="job_id", shape=[1], dtype="int64")
    usr_job_emb = fluid.layers.embedding(
        input=usr_job_id, size=[job_size, emb_dim // 2],
        param_attr="job_table", is_sparse=IS_SPARSE)
    usr_job_fc = fluid.layers.fc(input=usr_job_emb, size=emb_dim // 2)

    concat_embed = fluid.layers.concat(
        input=[usr_fc, usr_gender_fc, usr_age_fc, usr_job_fc], axis=1)
    return fluid.layers.fc(input=concat_embed, size=fc_dim, act="tanh")


def get_mov_combined_features(emb_dim=32, fc_dim=200):
    mov_dict_size = movielens.max_movie_id() + 1
    mov_id = fluid.layers.data(name="movie_id", shape=[1], dtype="int64")
    mov_emb = fluid.layers.embedding(
        input=mov_id, dtype="float32", size=[mov_dict_size, emb_dim],
        param_attr="movie_table", is_sparse=IS_SPARSE)
    mov_fc = fluid.layers.fc(input=mov_emb, size=emb_dim)

    category_size = len(movielens.movie_categories())
    category_id = fluid.layers.data(
        name="category_id", shape=[1], dtype="int64", lod_level=1)
    mov_categories_emb = fluid.layers.embedding(
        input=category_id, size=[category_size, emb_dim],
        is_sparse=IS_SPARSE)
    mov_categories_hidden = fluid.layers.sequence_pool(
        input=mov_categories_emb, pool_type="sum")

    title_size = len(movielens.get_movie_title_dict())
    mov_title_id = fluid.layers.data(
        name="movie_title", shape=[1], dtype="int64", lod_level=1)
    mov_title_emb = fluid.layers.embedding(
        input=mov_title_id, size=[title_size, emb_dim], is_sparse=IS_SPARSE)
    mov_title_conv = nets.sequence_conv_pool(
        input=mov_title_emb, num_filters=emb_dim, filter_size=3, act="tanh",
        pool_type="sum")

    concat_embed = fluid.layers.concat(
        input=[mov_fc, mov_categories_hidden, mov_title_conv], axis=1)
    return fluid.layers.fc(input=concat_embed, size=fc_dim, act="tanh")


def model(emb_dim=32, fc_dim=200):
    usr_combined_features = get_usr_combined_features(emb_dim, fc_dim)
    mov_combined_features = get_mov_combined_features(emb_dim, fc_dim)

    inference = fluid.layers.cos_sim(X=usr_combined_features,
                                     Y=mov_combined_features)
    scale_infer = fluid.layers.scale(x=inference, scale=5.0)

    label = fluid.layers.data(name="score", shape=[1], dtype="float32")
    square_cost = fluid.layers.square_error_cost(input=scale_infer,
                                                 label=label)
    avg_cost = fluid.layers.mean(x=square_cost)
    return scale_infer, avg_cost


def build_train(learning_rate=0.2, emb_dim=32, fc_dim=200):
    scale_infer, avg_cost = model(emb_dim, fc_dim)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    return scale_infer, avg_cost
