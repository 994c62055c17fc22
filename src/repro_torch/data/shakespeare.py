"""Shakespeare character-LM data (paper Fig. 6, the RNN task).

A copy of ``repro/data/shakespeare.py`` (numpy only): the embedded
public-domain excerpt (sonnets and play fragments), tiled with light
stochastic re-ordering to the requested corpus size
(:func:`load_shakespeare`), and the federated sharding of
:func:`char_shards`: a positionally disjoint train / test split
(:func:`split_stream`), train windows drawn per seed, each labelled with
the tenth of the corpus it starts in (the "which play" proxy) so that the
partitioners of :mod:`repro_torch.data` deal them to devices, and eval
windows from the test tail.  The same seed gives the same stream, shards
and eval arrays as the reference (tests/test_torch_shakespeare.py).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

_EXCERPT = """
Shall I compare thee to a summer's day?
Thou art more lovely and more temperate:
Rough winds do shake the darling buds of May,
And summer's lease hath all too short a date;
Sometime too hot the eye of heaven shines,
And often is his gold complexion dimm'd;
And every fair from fair sometime declines,
By chance or nature's changing course untrimm'd;
But thy eternal summer shall not fade,
Nor lose possession of that fair thou ow'st;
Nor shall death brag thou wander'st in his shade,
When in eternal lines to time thou grow'st:
So long as men can breathe or eyes can see,
So long lives this, and this gives life to thee.

To be, or not to be, that is the question:
Whether 'tis nobler in the mind to suffer
The slings and arrows of outrageous fortune,
Or to take arms against a sea of troubles
And by opposing end them. To die: to sleep;
No more; and by a sleep to say we end
The heart-ache and the thousand natural shocks
That flesh is heir to, 'tis a consummation
Devoutly to be wish'd. To die, to sleep;
To sleep: perchance to dream: ay, there's the rub;
For in that sleep of death what dreams may come
When we have shuffled off this mortal coil,
Must give us pause: there's the respect
That makes calamity of so long life;

All the world's a stage,
And all the men and women merely players;
They have their exits and their entrances,
And one man in his time plays many parts,
His acts being seven ages. At first the infant,
Mewling and puking in the nurse's arms;
And then the whining school-boy, with his satchel
And shining morning face, creeping like snail
Unwillingly to school. And then the lover,
Sighing like furnace, with a woeful ballad
Made to his mistress' eyebrow. Then a soldier,
Full of strange oaths, and bearded like the pard,
Jealous in honour, sudden and quick in quarrel,
Seeking the bubble reputation
Even in the cannon's mouth.

Friends, Romans, countrymen, lend me your ears;
I come to bury Caesar, not to praise him.
The evil that men do lives after them;
The good is oft interred with their bones;
So let it be with Caesar. The noble Brutus
Hath told you Caesar was ambitious:
If it were so, it was a grievous fault,
And grievously hath Caesar answer'd it.

Now is the winter of our discontent
Made glorious summer by this sun of York;
And all the clouds that lour'd upon our house
In the deep bosom of the ocean buried.
Now are our brows bound with victorious wreaths;
Our bruised arms hung up for monuments;
Our stern alarums changed to merry meetings,
Our dreadful marches to delightful measures.
"""

CHAR_VOCAB = sorted(set(_EXCERPT))
_STOI = {c: i for i, c in enumerate(CHAR_VOCAB)}
VOCAB_SIZE = len(CHAR_VOCAB)


def load_shakespeare(n_chars: int = 200_000, seed: int = 0) -> np.ndarray:
    """Return an int32 token stream of ~n_chars characters."""
    rng = np.random.default_rng(seed)
    lines = [l for l in _EXCERPT.strip().split("\n\n")]
    chunks = []
    total = 0
    while total < n_chars:
        li = rng.integers(0, len(lines))
        chunks.append(lines[li] + "\n\n")
        total += len(chunks[-1])
    text = "".join(chunks)[:n_chars]
    return np.array([_STOI[c] for c in text], np.int32)


def char_batches(stream: np.ndarray, batch: int, seq: int,
                 rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Sample (inputs, targets) next-char pairs of shape (batch, seq)."""
    x, y, _ = char_windows(stream, batch, seq, rng)
    return x, y


def char_windows(stream: np.ndarray, n: int, seq: int,
                 rng: np.random.Generator
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``char_batches`` that also returns the window start positions, so
    callers can derive position-based metadata (region labels, overlap
    checks)."""
    starts = rng.integers(0, stream.shape[0] - seq - 1, n)
    x = np.stack([stream[s:s + seq] for s in starts])
    y = np.stack([stream[s + 1:s + seq + 1] for s in starts])
    return x, y, starts


def split_stream(stream: np.ndarray, test_frac: float = 0.15
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Cut a character stream into disjoint (train, test) tails.

    The test split is the *tail* of the stream, carved before any window is
    drawn, so held-out evaluation sequences share no character position with
    any device shard (tests/test_torch_shakespeare.py).

    Caveat: the guarantee is *positional*, not content-level.  The embedded
    corpus tiles a ~2.5 KB excerpt to size, so most eval windows have
    byte-identical twins in the train region; eval numbers on the synthetic
    stream measure fitting, not generalization.  Swap in a real corpus
    (one untiled pass of text) and the positional split becomes a true
    held-out split with no code change.
    """
    if not 0.0 < test_frac < 1.0:
        raise ValueError(f"test_frac must be in (0, 1), got {test_frac}")
    cut = stream.shape[0] - max(1, int(round(stream.shape[0] * test_frac)))
    if cut < 1:
        raise ValueError(
            f"stream of {stream.shape[0]} chars leaves no train split at "
            f"test_frac={test_frac}")
    return stream[:cut], stream[cut:]


N_REGIONS = 10   # corpus tenths used as the "which play" pseudo-labels


def char_shards(stream: np.ndarray, m_devices: int, *, seq: int,
                n_train: int, n_eval: int, seed: int,
                partition_fn: Callable[[np.ndarray, np.ndarray, int, int],
                                       list],
                test_frac: float = 0.15
                ) -> tuple[list[tuple[np.ndarray, np.ndarray]],
                           tuple[np.ndarray, np.ndarray]]:
    """Deterministic federated shards + held-out eval batch for a char LM.

    1. ``split_stream`` carves a positionally disjoint test tail (see its
       docstring for the content-duplication caveat of the tiled synthetic
       corpus).
    2. ``n_train`` (input, target) windows of length ``seq`` are drawn from
       the train split with ``default_rng(seed)`` -- fully deterministic.
       The eval windows come from an *independent* generator, so the
       held-out set is a fixed function of (seed, seq, n_eval) and stays
       comparable across train budgets.
    3. Each window is labeled with the corpus region (tenth) it starts in,
       and ``partition_fn(x, labels, m, seed)`` -- any partitioner of
       :mod:`repro_torch.data` -- deals the windows to devices by that
       label, giving character data the same statistical-heterogeneity
       controls as MNIST.
    4. The eval batch is drawn from the test split only.
    """
    train, test = split_stream(stream, test_frac)
    if test.shape[0] <= seq + 1 or train.shape[0] <= seq + 1:
        raise ValueError(
            f"splits of {train.shape[0]}/{test.shape[0]} chars are shorter "
            f"than seq+1={seq + 1}; lower seq or test_frac")
    rng = np.random.default_rng(seed)
    x, y, starts = char_windows(train, n_train, seq, rng)
    regions = (starts.astype(np.int64) * N_REGIONS
               // train.shape[0]).astype(np.int32)
    # partition *indices* by region label, then gather the windows: the
    # partitioners see (index-column, label) arrays, so their exact-partition
    # and determinism guarantees transfer unchanged
    idx_shards = partition_fn(np.arange(n_train, dtype=np.int64)[:, None],
                              regions, m_devices, seed)
    shards = [(x[ids[:, 0]], y[ids[:, 0]]) for ids, _ in idx_shards]
    # independent stream: the eval set must not move when n_train (or any
    # other train-side draw) changes
    xte, yte, _ = char_windows(test, n_eval, seq,
                               np.random.default_rng((seed, 0xE7A1)))
    return shards, (xte, yte)
