"""The stacked dynamic-LSTM sentiment LM (benchmark/fluid's
stacked_dynamic_lstm).

Counterpart of paddle_tpu/models/stacked_lstm.py.  Ragged reviews feed as
padded + lengths LoDTensors (core/lod.py); each LSTM layer is one `lstm`
op, its recurrence a loop of torch ops over T with the carry held past a
row's length (ops/sequence.py); layers 2, 4, ... run reversed.
"""
from .. import layers, optimizer


def lstm_net(data, dict_dim, emb_dim=512, hid_dim=512, stacked_num=3,
             class_dim=2):
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    fc1 = layers.fc(input=emb, size=hid_dim * 4)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim * 4,
                                   use_peepholes=False)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim * 4)
        lstm, _ = layers.dynamic_lstm(
            input=fc, size=hid_dim * 4, is_reverse=(i % 2) == 0,
            use_peepholes=False)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act='softmax')
    return prediction


def build(dict_dim=5147, emb_dim=512, hid_dim=512, stacked_num=3,
          class_dim=2, lr=0.002, is_train=True):
    data = layers.data(name='words', shape=[1], dtype='int64', lod_level=1)
    label = layers.data(name='label', shape=[1], dtype='int64')
    prediction = lstm_net(data, dict_dim, emb_dim, hid_dim, stacked_num,
                          class_dim)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(x=cost)
    batch_acc = layers.accuracy(input=prediction, label=label)
    opt = None
    if is_train:
        opt = optimizer.Adam(learning_rate=lr)
        opt.minimize(avg_cost)
    return {'loss': avg_cost, 'accuracy': batch_acc,
            'feeds': [data, label], 'predict': prediction, 'optimizer': opt}
