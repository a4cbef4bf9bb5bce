"""Small book models: fit_a_line (linear regression) and recommender.

Counterpart of paddle_tpu/models/simple.py (book chapters 1 and 5):
`fit_a_line` is one fc over 13 features, square_error_cost, SGD;
`recommender` scores a (user, movie) pair as 5 cos_sim of a user tower
(id, gender, age and job embeddings) and a movie tower (id embedding,
the summed category embeddings, and a sequence_conv_pool over the title's
words), trained by SGD on the squared error, at MovieLens-1M's widths.
"""
from .. import layers, nets, optimizer


def fit_a_line(lr=0.01, is_train=True):
    x = layers.data('x', shape=[13], dtype='float32')
    y = layers.data('y', shape=[1], dtype='float32')
    y_predict = layers.fc(input=x, size=1, act=None)
    cost = layers.square_error_cost(input=y_predict, label=y)
    avg_cost = layers.mean(cost)
    opt = None
    if is_train:
        opt = optimizer.SGD(learning_rate=lr)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'predict': y_predict, 'feeds': [x, y],
            'optimizer': opt}


def recommender(n_users=6041, n_movies=3953, n_jobs=21, n_ages=7,
                n_cats=18, title_vocab=5175, dim=32, lr=1e-3,
                is_train=True):
    uid = layers.data('user_id', shape=[1], dtype='int64')
    gender = layers.data('gender_id', shape=[1], dtype='int64')
    age = layers.data('age_id', shape=[1], dtype='int64')
    job = layers.data('job_id', shape=[1], dtype='int64')
    mid = layers.data('movie_id', shape=[1], dtype='int64')
    cats = layers.data('category_id', shape=[1], dtype='int64', lod_level=1)
    title = layers.data('movie_title', shape=[1], dtype='int64',
                        lod_level=1)
    score = layers.data('score', shape=[1], dtype='float32')

    usr = layers.fc(layers.embedding(uid, [n_users, dim]), dim)
    g = layers.fc(layers.embedding(gender, [2, dim // 2]), dim // 2)
    a = layers.fc(layers.embedding(age, [n_ages, dim // 2]), dim // 2)
    j = layers.fc(layers.embedding(job, [n_jobs, dim // 2]), dim // 2)
    usr_combined = layers.fc(layers.concat([usr, g, a, j], axis=1), 200,
                             act='tanh')

    mov = layers.fc(layers.embedding(mid, [n_movies, dim]), dim)
    cat = layers.sequence_pool(layers.embedding(cats, [n_cats, dim]),
                               pool_type='sum')
    tit = nets.sequence_conv_pool(
        input=layers.embedding(title, [title_vocab, dim]),
        num_filters=dim, filter_size=3, act='tanh', pool_type='sum')
    mov_combined = layers.fc(layers.concat([mov, cat, tit], axis=1), 200,
                             act='tanh')

    inference = layers.scale(
        layers.cos_sim(usr_combined, mov_combined), scale=5.0)
    cost = layers.square_error_cost(inference, score)
    avg_cost = layers.mean(cost)
    opt = None
    if is_train:
        opt = optimizer.SGD(learning_rate=lr)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'predict': inference, 'optimizer': opt,
            'feeds': [uid, gender, age, job, mid, cats, title, score]}
