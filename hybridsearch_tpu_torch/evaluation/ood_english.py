"""Held-out real-English OOD retrieval eval (the port of
``hybridsearch_tpu/evaluation/ood_english.py``; no download needed).

144 hand-authored (query, relevant passage) pairs across 12 domains.
None of this text appears in the synthetic training mix
(scripts/train_encoder.py), so it measures out-of-distribution English
quality of the in-repo-trained encoders against the hashing baseline
and BM25 — the role BEIR SciFact / MS MARCO dev play in BASELINE.md
configs 3-4 while those datasets stay unfetchable (docs/
DATASETS_FETCH.log). Each pair was written so lexical overlap with its
query VARIES: roughly a third are near-paraphrases with almost no
shared content words (the semantic-generalization probe), a third share
one or two terms, a third are keyword-matchable (BM25's home turf).

The eval treats ALL 144 passages as one retrieval corpus: every query's
other 143 passages are distractors, with same-domain passages acting as
hard negatives. It also derives query-positive-negative triples
(144 pairs x sampled negatives) for pairwise cross-encoder accuracy —
hundreds of triples from a hand-curated base (VERDICT r4 ask 8 scaled
the previous 18-triple sanity check).

Every pair carries its authored overlap TIER and metrics report per
tier, so a soft lexical matcher (what the in-repo contrastive training
produces) and a true semantic encoder are distinguishable:
  kw      — most query terms appear verbatim in the passage
  partial — one or two query terms appear; the rest is paraphrase
  para    — zero content-word overlap; meaning only
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from hybridsearch_tpu_torch.evaluation.metrics import host_array

# (query, relevant passage, tier) — grouped by domain; domain boundaries
# matter for hard-negative attribution in the report.
PAIRS_BY_DOMAIN: Dict[str, List[Tuple[str, str, str]]] = {
    "software": [
        ("python error handling",
         "error handling in python wraps risky calls in try and except "
         "blocks so the interpreter can recover instead of crashing",
         "kw"),
        ("fix a memory leak",
         "a memory leak means the heap keeps growing because allocated "
         "objects are never released; fix it by profiling what still "
         "holds them", "kw"),
        ("version control merge conflict",
         "a merge conflict happens when two version control branches "
         "edit the same lines and git asks you to reconcile them by "
         "hand", "kw"),
        ("speed up a slow database query",
         "to speed up a slow database query, add an index on the "
         "filtered column so the planner skips the full table scan",
         "kw"),
        ("what is a race condition",
         "the race happens when two threads touch shared state without "
         "synchronization, so the result depends on which runs first",
         "partial"),
        ("rolling deployment strategy",
         "a rolling update replaces servers a few at a time behind the "
         "load balancer so users never see the fleet go down", "partial"),
        ("unit test best practices",
         "keep each test small, independent, and focused on one behavior "
         "so failures point straight at the broken code", "partial"),
        ("rest api pagination",
         "the api returns results a page at a time with a cursor token "
         "the client echoes back for the next slice", "partial"),
        ("container image too large",
         "use a slim base layer and multi-stage builds so the final "
         "artifact ships only what the runtime needs", "para"),
        ("garbage collection pause",
         "the runtime briefly stops every thread while it traces live "
         "objects, which shows up as latency spikes", "para"),
        ("regular expression for email",
         "a pattern matching text before and after an at sign is usually "
         "enough; validating full addresses is notoriously hairy",
         "para"),
        ("binary search precondition",
         "the array must already be sorted, otherwise halving the range "
         "discards the region holding the answer", "para"),
    ],
    "cooking": [
        ("how to cook pasta properly",
         "to cook pasta properly, boil generously salted water, stir the "
         "noodles early, and pull them while still firm", "kw"),
        ("bread dough will not rise",
         "bread dough will not rise when the yeast sat too long or the "
         "water was too hot, leaving the loaf dense and flat", "kw"),
        ("searing a steak",
         "searing a steak needs a ripping hot pan and dry meat; moisture "
         "steams where browning wants contact heat", "kw"),
        ("balance a sauce that is too salty",
         "a sauce that tastes too salty balances out with unsalted stock "
         "or a touch of acid and sugar", "kw"),
        ("why rest meat after roasting",
         "resting lets the juices redistribute as the temperature evens "
         "out, so slicing early spills what should stay in the cut",
         "partial"),
        ("homemade vinaigrette ratio",
         "the classic vinaigrette whisks one part vinegar into three "
         "parts oil with mustard to hold the emulsion", "partial"),
        ("caramelize onions",
         "cook the onions low and slow, stirring now and then, until "
         "their sugars brown into a deep sweet jam", "partial"),
        ("keep herbs fresh longer",
         "fresh herbs last longer with trimmed stems stood in a glass of "
         "water in the fridge like a bouquet", "partial"),
        ("crispy roast potatoes",
         "parboil, rough up the surfaces, then bake in hot fat so the "
         "ragged edges fry crunchy", "para"),
        ("substitute for buttermilk",
         "stir a spoonful of lemon juice into regular milk and let it "
         "curdle for a few minutes", "para"),
        ("knife stays sharp",
         "hone the edge before each session and grind on a stone when "
         "honing stops bringing the bite back", "para"),
        ("risotto technique",
         "add warm stock a ladle at a time, stirring so the rice "
         "releases starch into a creamy suspension", "para"),
    ],
    "finance": [
        ("stock market reaction to earnings",
         "the stock market rallied after the earnings report beat "
         "quarterly profit expectations and guidance was raised", "kw"),
        ("what drives mortgage rates",
         "mortgage rates are driven by long-term bond yields plus a "
         "lender margin for credit and prepayment risk", "kw"),
        ("diversify an investment portfolio",
         "a diversified investment portfolio spreads money across assets "
         "that do not move together, cutting single-holding damage",
         "kw"),
        ("inflation eroding savings",
         "inflation erodes savings when prices rise faster than interest "
         "accrues and the cash quietly loses purchasing power", "kw"),
        ("emergency fund size",
         "the standard emergency cushion is three to six months of "
         "essential expenses kept somewhere liquid", "partial"),
        ("compound interest explained",
         "with compounding, earnings get reinvested so growth feeds on "
         "itself — starting early beats starting big", "partial"),
        ("index fund versus active manager",
         "most active stock pickers trail the index after fees over long "
         "stretches, favoring the cheap passive fund", "partial"),
        ("credit score improvement",
         "a credit history improves by paying every bill on time and "
         "keeping card balances well below their limits", "partial"),
        ("bond prices and interest rates",
         "existing debt falls in value when newer issues pay higher "
         "coupons, and rises when yields sink", "para"),
        ("dollar cost averaging",
         "investing a fixed amount on a schedule buys more shares when "
         "prices dip and fewer when they spike", "para"),
        ("company balance sheet basics",
         "assets sit on one side, liabilities and shareholder equity on "
         "the other, and the two sides must match", "para"),
        ("hedging currency exposure",
         "an exporter locks tomorrow's exchange rate with a forward "
         "contract so revenue abroad keeps its value at home", "para"),
    ],
    "health": [
        ("lower blood pressure naturally",
         "blood pressure often comes down naturally by cutting sodium, "
         "moving daily, and keeping weight in check", "kw"),
        ("why sleep matters for memory",
         "sleep matters for memory because deep stages replay the day "
         "and file new information into long-term storage", "kw"),
        ("signs of dehydration",
         "the early signs of dehydration — dark urine, headache, and "
         "fatigue — usually show up before real thirst", "kw"),
        ("stretching before exercise",
         "stretching before exercise works best as light movement; long "
         "static holds on cold muscle sap power", "kw"),
        ("antibiotics and viruses",
         "antibiotics kill bacteria only, doing nothing for a cold or "
         "the flu, and overuse breeds resistance", "partial"),
        ("building muscle after forty",
         "past forty, muscle holds on through progressive resistance "
         "training plus adequate protein", "partial"),
        ("seasonal allergy triggers",
         "allergy flares track pollen counts, which spike on dry windy "
         "mornings with itchy eyes and sneezing", "partial"),
        ("sunscreen reapplication",
         "sunscreen fades with swimming and sweat, so coat exposed skin "
         "again every couple of hours outdoors", "partial"),
        ("iron deficiency symptoms",
         "pale skin, brittle nails, and exhaustion can signal the blood "
         "is short on the mineral that carries oxygen", "para"),
        ("benefits of walking daily",
         "a brisk half hour on foot most days strengthens the heart, "
         "steadies mood, and costs nothing", "para"),
        ("posture at a desk job",
         "raise the screen to eye level and keep feet flat so the spine "
         "stacks instead of slumping forward", "para"),
        ("recovering from a sprained ankle",
         "rest the joint briefly, then restore motion and balance "
         "gradually; total immobilization slows the comeback", "para"),
    ],
    "travel": [
        ("avoid jet lag on long flights",
         "to avoid jet lag on a long flight, shift sleep toward the "
         "destination time zone early and chase daylight after landing",
         "kw"),
        ("packing light for two weeks",
         "packing light for two weeks means clothes that all match, "
         "rolled tight, with a mid-trip wash instead of spares", "kw"),
        ("best time to book airfare",
         "the best time to book airfare tends to be a few weeks out on "
         "off-peak days rather than the last minute", "kw"),
        ("travel insurance worth it",
         "travel insurance is worth it when the cheap policy covers "
         "medical evacuation far from home", "kw"),
        ("getting around tokyo",
         "in tokyo a rechargeable transit card works on nearly every "
         "train, subway, and bus in the metropolitan area", "partial"),
        ("altitude sickness prevention",
         "to prevent the sickness, climb slowly, sleep lower than the "
         "day's high point, and drink plenty in the thin air", "partial"),
        ("overbooked flight rights",
         "passengers bumped from an oversold flight are usually owed "
         "cash compensation and the next departure", "partial"),
        ("street food safety",
         "street stalls are safest with a long local queue and food "
         "cooked hot to order in front of you", "partial"),
        ("renting a car abroad",
         "check whether your license needs an international permit and "
         "decline duplicate coverage you already hold", "para"),
        ("museum lines in paris",
         "timed-entry tickets bought online let you walk past the queue "
         "that wraps around the louvre courtyard", "para"),
        ("motion sickness on boats",
         "stay on deck, watch the horizon, and keep something bland in "
         "your stomach before the swell builds", "para"),
        ("visa on arrival rules",
         "some borders stamp you in for a fee with just a passport "
         "photo, while others demand paperwork weeks ahead", "para"),
    ],
    "nature": [
        ("why leaves change color in autumn",
         "leaves change color in autumn as chlorophyll breaks down and "
         "the yellows and reds it masked all summer show through", "kw"),
        ("whale migration distance",
         "the gray whale migration covers thousands of miles each year "
         "between arctic feeding grounds and warm calving lagoons",
         "kw"),
        ("how bees make honey",
         "bees make honey by carrying nectar home, passing it mouth to "
         "mouth to thicken, then fanning it dry in wax cells", "kw"),
        ("tides and the moon",
         "the moon's gravity drags a tide bulge of ocean around the "
         "planet, giving most coasts two highs and two lows a day",
         "kw"),
        ("old growth forest value",
         "old growth canopies shelter species and store carbon in ways "
         "young plantations cannot match", "partial"),
        ("desert plants conserve water",
         "desert succulents hoard moisture in fleshy tissue and open "
         "their pores at night to cut evaporation", "partial"),
        ("bird migration navigation",
         "migrating songbirds cross continents steering by stars, "
         "landmarks, and a compass tuned to the magnetic field",
         "partial"),
        ("coral bleaching cause",
         "bleaching happens when heat-stressed coral polyps expel their "
         "symbiotic algae and lose pigment and food supply", "partial"),
        ("wolf pack structure",
         "a breeding pair leads the group, which is mostly their own "
         "offspring hunting and raising pups together", "para"),
        ("lightning formation",
         "charge separates inside a storm cloud until the voltage rips a "
         "conductive channel through the air", "para"),
        ("salmon returning to spawn",
         "after years at sea the fish smell their way back to the exact "
         "gravel bed where they hatched", "para"),
        ("mushroom and tree symbiosis",
         "fungal threads wrap roots, trading soil minerals for sugars in "
         "a partnership older than forests", "para"),
    ],
    "home": [
        ("unclog a kitchen drain",
         "to unclog a kitchen drain, pour a kettle of boiling water and "
         "plunge before resorting to a snake", "kw"),
        ("paint a room like a pro",
         "to paint a room like a pro, cut in the edges with a brush "
         "first, then roll overlapping strokes while the border is wet",
         "kw"),
        ("squeaky door hinge",
         "a squeaky door hinge goes silent with a drop of oil on the "
         "pin, worked in by swinging the door", "kw"),
        ("lower the electric bill",
         "the electric bill drops when you seal drafts, swap old bulbs, "
         "and let a programmable thermostat idle the house", "kw"),
        ("remove red wine stain",
         "a red wine spill lifts out if you blot immediately, never rub, "
         "then work in cold water and dish soap", "partial"),
        ("when to water houseplants",
         "water the houseplants only when the top inch of potting soil "
         "feels dry to a poked finger, not on a calendar", "partial"),
        ("hang a heavy mirror",
         "a heavy frame needs the stud or rated anchors; drywall alone "
         "will not hold the weight for long", "partial"),
        ("smoke detector placement",
         "mount a smoke alarm inside each bedroom and on every level, "
         "away from the kitchen's false-alarm steam", "partial"),
        ("compost at home",
         "layer vegetable scraps with dry leaves and turn the pile so "
         "microbes get the air they need to work", "para"),
        ("hard water spots on glass",
         "white mineral film wipes away with diluted vinegar that "
         "dissolves the calcium the tap left behind", "para"),
        ("organize a small closet",
         "double the hanging rods, use slim hangers, and move off-season "
         "clothes into boxes up top", "para"),
        ("prevent frozen pipes",
         "let faucets drip on bitter nights and open cabinet doors so "
         "warm room air reaches the plumbing", "para"),
    ],
    "sports": [
        ("improve marathon time",
         "to improve a marathon time, build weekly mileage slowly and "
         "make one session a tempo run near race pace", "kw"),
        ("goalkeeper penalty save",
         "a goalkeeper saves a penalty by reading the striker's hips and "
         "plant foot, committing before the ball is struck", "kw"),
        ("tennis serve technique",
         "good serve technique in tennis tosses the ball slightly in "
         "front, coils the shoulders, and snaps the wrist at stretch",
         "kw"),
        ("basketball shooting form",
         "basketball shooting form squares to the rim, keeps the elbow "
         "under the ball, and follows through at the target", "kw"),
        ("cycling uphill efficiency",
         "climbing efficiently on a bike means staying seated at a high "
         "cadence in an easy gear, not mashing from the saddle",
         "partial"),
        ("swimming freestyle breathing",
         "in freestyle, exhale underwater and roll with the stroke so "
         "the mouth clears the surface without lifting the head",
         "partial"),
        ("offside rule explained",
         "the rule flags an attacker played the ball while standing "
         "nearer the goal than the last defender", "partial"),
        ("strength training for runners",
         "runners benefit from squats and single-leg work that stiffen "
         "each stride's spring and guard against overuse", "partial"),
        ("golf swing slice fix",
         "an open clubface at contact curves the shot away; strengthen "
         "the grip and come more from the inside", "para"),
        ("rock climbing grip strength",
         "hang from a fingerboard in short sets; tendons adapt slower "
         "than muscles, so progress patiently", "para"),
        ("baseball pitch types",
         "a fastball rides straight, a curve tumbles, and a changeup "
         "sells arm speed it never delivers", "para"),
        ("recovery between workouts",
         "muscles grow during rest, so alternate hard days with sleep, "
         "food, and easy movement", "para"),
    ],
    "science": [
        ("how vaccines train immunity",
         "vaccines train immunity with a harmless preview of the "
         "pathogen that teaches white blood cells to destroy the real "
         "thing", "kw"),
        ("protein folding importance",
         "protein folding matters because a chain of amino acids only "
         "works once it collapses into the precise shape its job "
         "requires", "kw"),
        ("why the sky is blue",
         "the sky looks blue because air molecules scatter short blue "
         "wavelengths of sunlight far more than red ones", "kw"),
        ("black hole event horizon",
         "a black hole's event horizon is the boundary inside which "
         "escape would take more than light speed", "kw"),
        ("plate tectonics earthquakes",
         "earthquakes strike where crustal plates grind past each other "
         "until the fault slips and the ground shakes", "partial"),
        ("antibiotic resistance evolution",
         "resistance evolves because bacteria that survive a drug pass "
         "on their defenses, selecting tougher strains", "partial"),
        ("photosynthesis energy source",
         "photosynthesis runs on captured sunlight, splitting water and "
         "forging sugar from carbon dioxide", "partial"),
        ("superconductors zero resistance",
         "below a critical temperature a superconductor carries current "
         "forever without losing energy as heat", "partial"),
        ("dna replication fidelity",
         "the copying enzymes proofread each new base, keeping mistakes "
         "to roughly one per billion letters", "para"),
        ("greenhouse effect mechanism",
         "certain atmospheric gases let sunlight in but absorb the "
         "infrared the warm surface radiates back", "para"),
        ("radiocarbon dating limits",
         "the isotope's half-life makes the clock useless beyond about "
         "fifty thousand years", "para"),
        ("quantum entanglement basics",
         "measuring one paired particle instantly fixes the other's "
         "state, however far apart they have drifted", "para"),
    ],
    "arts": [
        ("impressionist painting style",
         "the impressionist style favored loose visible brushwork and "
         "outdoor light over crisp studio painting detail", "kw"),
        ("violin section rehearsal",
         "at rehearsal the violin section drilled the symphony's opening "
         "passage until their bowing moved as one arm", "kw"),
        ("novel point of view choices",
         "a novel's point of view choices run from first person inside "
         "one head to an omniscient narrator roaming the cast", "kw"),
        ("film editing pace",
         "a film's editing pace cranks tension with quick cuts in action "
         "and lets drama breathe in long takes", "kw"),
        ("pottery wheel centering",
         "centering on the wheel means pressing the spinning clay steady "
         "between braced hands before pulling a wall", "partial"),
        ("jazz improvisation basics",
         "jazz soloists improvise melodies in real time over the tune's "
         "chord changes, trading phrases with the band", "partial"),
        ("museum sculpture wing",
         "the museum's new wing gives the marble figures room to be "
         "circled and seen from every side", "partial"),
        ("photography golden hour",
         "photographers chase the hour after sunrise and before sunset, "
         "when low warm light flatters faces and landscapes", "partial"),
        ("theater stage blocking",
         "the director charts where each actor stands and moves so "
         "sightlines and focus land where the scene needs them", "para"),
        ("writing believable dialogue",
         "people interrupt, dodge questions, and leave things unsaid; "
         "speech on the page should too", "para"),
        ("ballet pointe work",
         "dancers build years of ankle and foot strength before rising "
         "onto the tips of reinforced shoes", "para"),
        ("street mural restoration",
         "conservators clean the faded wall painting and stabilize the "
         "pigment before retouching any lines", "para"),
    ],
    "history": [
        ("printing press impact",
         "the printing press's impact came from movable type making "
         "books cheap enough that ideas outran scribes and censors",
         "kw"),
        ("silk road trade goods",
         "silk road caravans traded textiles, spices, and goods across "
         "the deserts between china and the mediterranean", "kw"),
        ("roman aqueduct engineering",
         "roman aqueduct engineering carried mountain water across "
         "valleys on arched stone bridges at a gentle gradient", "kw"),
        ("transatlantic telegraph cable",
         "the transatlantic telegraph cable cut message time between "
         "continents from weeks by ship to minutes", "kw"),
        ("medieval castle defense",
         "a medieval stronghold defended itself with moats, murder "
         "holes, and staggered gates that trapped attackers", "partial"),
        ("industrial revolution textile mills",
         "the revolution's steam-driven textile looms pulled spinning "
         "and weaving out of cottages and into factories", "partial"),
        ("polar expedition survival",
         "the stranded polar crew wintered under an upturned boat, "
         "eating seal and penguin until rescue reached them", "partial"),
        ("ancient library of alexandria",
         "alexandria's scholars gathered scrolls from every docked ship, "
         "copying the known world's learning into one collection",
         "partial"),
        ("moon landing navigation",
         "a sextant, a primitive computer, and ground radar guided the "
         "lander to a boulder-free patch of the surface", "para"),
        ("great wall construction",
         "successive dynasties linked rammed-earth and brick ramparts "
         "into a frontier thousands of miles long", "para"),
        ("bronze age metallurgy",
         "smiths learned that a little tin melted into copper cast "
         "harder tools and deadlier blades", "para"),
        ("suez canal opening",
         "the new waterway let steamships skip the long passage around "
         "africa's southern cape", "para"),
    ],
    "food_retail": [
        ("sourdough bakery schedule",
         "the sourdough bakery's schedule feeds the starter at dawn and "
         "pulls the day's loaves by early morning", "kw"),
        ("coffee roast levels",
         "coffee roast levels trade off: lighter roasts keep bright "
         "origin flavors, darker ones buy smoky body", "kw"),
        ("farmers market seasonal produce",
         "the farmers market's seasonal produce peaks in late summer "
         "with tomatoes and corn picked the same morning", "kw"),
        ("cheese aging process",
         "the cheese aging process rests wheels in cool caves for months "
         "while enzymes deepen flavor and firm the paste", "kw"),
        ("olive oil quality grades",
         "extra virgin is the top grade of the oil: a first cold press "
         "that passed taste and acidity tests", "partial"),
        ("chocolate tempering",
         "tempering melts and cools the chocolate carefully so cocoa "
         "butter crystals align and the bar snaps glossy", "partial"),
        ("craft beer hops bitterness",
         "boiling hops longer extracts more bitterness into the beer, "
         "while late additions keep their aroma", "partial"),
        ("tea steeping temperature",
         "delicate green tea scorches in boiling water; pour well off "
         "the boil and steep briefly", "partial"),
        ("butcher dry aged beef",
         "weeks in a chilled locker concentrate the meat's flavor as "
         "enzymes tenderize the muscle", "para"),
        ("ice cream texture science",
         "fast churning keeps ice crystals tiny, which is what makes the "
         "scoop taste smooth instead of grainy", "para"),
        ("fermented vegetables safety",
         "salt brine lets good bacteria acidify the jar before spoilage "
         "organisms can take hold", "para"),
        ("restaurant mise en place",
         "every ingredient is prepped and stationed before service so "
         "the line can plate dishes in minutes", "para"),
    ],
}


def corpus_and_queries() -> Tuple[List[str], List[str], List[int],
                                  List[str], List[str]]:
    """(docs, queries, gold doc index, domain, tier) per query."""
    docs: List[str] = []
    queries: List[str] = []
    gold: List[int] = []
    domains: List[str] = []
    tiers: List[str] = []
    for dom, pairs in PAIRS_BY_DOMAIN.items():
        for q, d, tier in pairs:
            gold.append(len(docs))
            docs.append(d)
            queries.append(q)
            domains.append(dom)
            tiers.append(tier)
    return docs, queries, gold, domains, tiers


def triples(max_negs_per_pair: int = 4, seed: int = 0
            ) -> List[Tuple[str, str, str]]:
    """(query, positive, negative) triples: sampled negatives, half from
    the SAME domain (hard), half from other domains (easy)."""
    import random

    rng = random.Random(seed)
    docs, queries, gold, domains, _tiers = corpus_and_queries()
    out: List[Tuple[str, str, str]] = []
    by_dom: Dict[str, List[int]] = {}
    for i, dom in enumerate(domains):
        by_dom.setdefault(dom, []).append(gold[i])
    for qi, q in enumerate(queries):
        pos = docs[gold[qi]]
        same = [j for j in by_dom[domains[qi]] if j != gold[qi]]
        other = [g for g, dom in zip(gold, domains) if dom != domains[qi]]
        n_hard = max_negs_per_pair // 2
        for j in rng.sample(same, min(n_hard, len(same))):
            out.append((q, pos, docs[j]))
        for j in rng.sample(other, min(max_negs_per_pair - n_hard,
                                       len(other))):
            out.append((q, pos, docs[j]))
    return out


def _rank_metrics(order, gold, domains, tiers, queries) -> Dict[str, float]:
    import numpy as np

    p1 = float(np.mean(order[:, 0] == np.asarray(gold)))
    rr = []
    confus_same_dom = 0
    for i in range(len(queries)):
        hits = np.where(order[i] == gold[i])[0]
        rr.append(1.0 / (1 + int(hits[0])) if len(hits) else 0.0)
        if order[i, 0] != gold[i] and domains[order[i, 0]] == domains[i]:
            confus_same_dom += 1
    misses = sum(1 for i in range(len(queries)) if order[i, 0] != gold[i])
    out = {
        "p_at_1": round(p1, 4),
        "mrr_at_10": round(float(np.mean(rr)), 4),
        "n_queries": len(queries),
        "same_domain_confusion_share": round(
            confus_same_dom / misses, 3) if misses else 0.0,
    }
    for tier in ("kw", "partial", "para"):
        idx = [i for i, t in enumerate(tiers) if t == tier]
        if idx:
            out[f"p_at_1_{tier}"] = round(float(np.mean(
                order[idx, 0] == np.asarray(gold)[idx])), 4)
            out[f"mrr_at_10_{tier}"] = round(float(np.mean(
                [rr[i] for i in idx])), 4)
    return out


def eval_retrieval(encode_fn, k: int = 10) -> Dict[str, float]:
    """Dense retrieval over the 144-passage corpus: p@1, MRR@k overall
    and per overlap tier. encode_fn(list[str]) -> [n, d]."""
    import numpy as np

    docs, queries, gold, domains, tiers = corpus_and_queries()
    dv = host_array(encode_fn(docs))
    qv = host_array(encode_fn(queries))
    dv /= np.maximum(np.linalg.norm(dv, axis=1, keepdims=True), 1e-9)
    qv /= np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-9)
    sims = qv @ dv.T
    order = np.argsort(-sims, axis=1)[:, :k]
    return _rank_metrics(order, gold, domains, tiers, queries)


def eval_bm25(device=None) -> Dict[str, float]:
    """BM25 retrieval (on ``device``) over the same corpus (lexical
    reference arm)."""
    from hybridsearch_tpu_torch.index.sparse_index import BM25
    from hybridsearch_tpu_torch.text.extractor import extract_tokens

    import numpy as np

    docs, queries, gold, domains, tiers = corpus_and_queries()
    bm = BM25(device=device)
    bm.fit_tokens([extract_tokens(d) for d in docs])
    order = np.stack([np.argsort(-np.asarray(bm.score_all(q)))[:10]
                      for q in queries])
    return _rank_metrics(order, gold, domains, tiers, queries)


def eval_cross_encoder(predict_fn, max_negs_per_pair: int = 4
                       ) -> Dict[str, float]:
    """Pairwise accuracy of a CE scorer over the derived triples,
    reported overall and on the hard (same-domain) half."""
    import numpy as np

    trip = triples(max_negs_per_pair=max_negs_per_pair)
    docs, queries, gold, domains, _tiers = corpus_and_queries()
    dom_of_doc = {}
    for g, dom in zip(gold, domains):
        dom_of_doc[docs[g]] = dom
    sp = host_array(predict_fn([(q, p) for q, p, _n in trip]))
    sn = host_array(predict_fn([(q, n) for q, _p, n in trip]))
    wins = sp > sn
    hard = np.asarray([dom_of_doc.get(n) == dom_of_doc.get(p)
                       for _q, p, n in trip])
    out = {
        "pairwise_acc": round(float(np.mean(wins)), 4),
        "n_triples": len(trip),
        "margin_mean": round(float(np.mean(sp - sn)), 3),
    }
    if hard.any():
        out["pairwise_acc_hard"] = round(float(np.mean(wins[hard])), 4)
        out["pairwise_acc_easy"] = round(float(np.mean(wins[~hard])), 4)
    return out
